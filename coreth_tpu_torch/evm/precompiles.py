"""Precompiled contracts.

Port of reference ``evm/precompiles.py``, with ``is_prohibited`` (the
reference keeps it in ``processor/state_transition.py``) beside the
addresses it tests.  Twin of reference core/vm/contracts.go (classic set, per-fork registries
:59-163) + contracts_stateful_native_asset.go (Avalanche native-asset
precompiles).  Each precompile is (required_gas(input), run(...)); the
native-asset pair is stateful and receives the EVM.
"""

from __future__ import annotations

import hashlib
from typing import Dict

from coreth_tpu_torch.crypto import secp256k1
from coreth_tpu_torch.evm import bn256, vmerrs
from coreth_tpu_torch.evm.blake2 import blake2f_precompile
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.precompile.modules import reserved_address


def _addr(n: int) -> bytes:
    return n.to_bytes(20, "big")


ECRECOVER_ADDR = _addr(1)
SHA256_ADDR = _addr(2)
RIPEMD160_ADDR = _addr(3)
IDENTITY_ADDR = _addr(4)
MODEXP_ADDR = _addr(5)
BN256_ADD_ADDR = _addr(6)
BN256_MUL_ADDR = _addr(7)
BN256_PAIRING_ADDR = _addr(8)
BLAKE2F_ADDR = _addr(9)
# Avalanche-specific (contracts.go:40-50)
GENESIS_CONTRACT_ADDR = bytes.fromhex(
    "0100000000000000000000000000000000000000")
NATIVE_ASSET_BALANCE_ADDR = bytes.fromhex(
    "0100000000000000000000000000000000000001")
NATIVE_ASSET_CALL_ADDR = bytes.fromhex(
    "0100000000000000000000000000000000000002")
# The blackhole address, prohibited as a call target (constants pkg)
BLACKHOLE_ADDR = bytes.fromhex("0100000000000000000000000000000000000000")


def _words(n: int) -> int:
    return (n + 31) // 32


class Precompile:
    def required_gas(self, input_: bytes) -> int:
        raise NotImplementedError

    def run(self, input_: bytes) -> bytes:
        """Returns output; raises VMError on precompile failure."""
        raise NotImplementedError


class Ecrecover(Precompile):
    def required_gas(self, input_):
        return P.ECRECOVER_GAS

    def run(self, input_):
        data = input_.ljust(128, b"\x00")[:128]
        h = data[0:32]
        v = int.from_bytes(data[32:64], "big")
        r = int.from_bytes(data[64:96], "big")
        s = int.from_bytes(data[96:128], "big")
        # v must be 27/28 with 32-byte alignment; r,s validated (allow
        # high-s: ecrecover precompile is homestead=false in geth)
        if v not in (27, 28):
            return b""
        if not (0 < r < secp256k1.N and 0 < s < secp256k1.N):
            return b""
        try:
            addr = secp256k1.recover_address(h, r, s, v - 27)
        except ValueError:
            return b""
        return addr.rjust(32, b"\x00")


class Sha256Hash(Precompile):
    def required_gas(self, input_):
        return _words(len(input_)) * P.SHA256_PER_WORD_GAS + P.SHA256_BASE_GAS

    def run(self, input_):
        return hashlib.sha256(input_).digest()


class Ripemd160Hash(Precompile):
    def required_gas(self, input_):
        return (_words(len(input_)) * P.RIPEMD160_PER_WORD_GAS
                + P.RIPEMD160_BASE_GAS)

    def run(self, input_):
        return hashlib.new("ripemd160", input_).digest().rjust(32, b"\x00")


class DataCopy(Precompile):
    def required_gas(self, input_):
        return (_words(len(input_)) * P.IDENTITY_PER_WORD_GAS
                + P.IDENTITY_BASE_GAS)

    def run(self, input_):
        return input_


class BigModExp(Precompile):
    """EIP-198 / EIP-2565 (contracts.go:334-446)."""

    def __init__(self, eip2565: bool):
        self.eip2565 = eip2565

    def _sizes(self, input_):
        header = input_.ljust(96, b"\x00")[:96]
        base_len = int.from_bytes(header[0:32], "big")
        exp_len = int.from_bytes(header[32:64], "big")
        mod_len = int.from_bytes(header[64:96], "big")
        return base_len, exp_len, mod_len

    def required_gas(self, input_):
        base_len, exp_len, mod_len = self._sizes(input_)
        body = input_[96:]
        # leading 32 bytes of the exponent
        if exp_len <= 32:
            exp_head = int.from_bytes(
                body[base_len:base_len + exp_len].ljust(exp_len, b"\x00"),
                "big") if exp_len else 0
        else:
            exp_head = int.from_bytes(
                body[base_len:base_len + 32].ljust(32, b"\x00"), "big")
        if exp_head == 0 and exp_len <= 32:
            adj_exp_len = 0
        elif exp_len <= 32:
            adj_exp_len = exp_head.bit_length() - 1
        else:
            adj_exp_len = 8 * (exp_len - 32) + max(
                exp_head.bit_length() - 1, 0)
        if self.eip2565:
            words = (max(base_len, mod_len) + 7) // 8
            mult = words * words
            gas = mult * max(adj_exp_len, 1) // 3
            return max(200, gas)
        x = max(base_len, mod_len)
        if x <= 64:
            mult = x * x
        elif x <= 1024:
            mult = x * x // 4 + 96 * x - 3072
        else:
            mult = x * x // 16 + 480 * x - 199680
        return mult * max(adj_exp_len, 1) // 20

    def run(self, input_):
        base_len, exp_len, mod_len = self._sizes(input_)
        if base_len == 0 and mod_len == 0:
            return b""
        body = input_[96:].ljust(base_len + exp_len + mod_len, b"\x00")
        base = int.from_bytes(body[0:base_len], "big")
        exp = int.from_bytes(body[base_len:base_len + exp_len], "big")
        mod = int.from_bytes(
            body[base_len + exp_len:base_len + exp_len + mod_len], "big")
        if mod == 0:
            return b"\x00" * mod_len
        return pow(base, exp, mod).to_bytes(mod_len, "big")


def _parse_g1(data: bytes):
    x = int.from_bytes(data[0:32], "big")
    y = int.from_bytes(data[32:64], "big")
    if x >= bn256.P or y >= bn256.P:
        raise vmerrs.VMError("bn256: coordinate >= modulus")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not bn256.is_on_curve_g1(pt):
        raise vmerrs.VMError("bn256: point not on curve")
    return pt


def _encode_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


class Bn256Add(Precompile):
    def __init__(self, istanbul: bool):
        self.gas = (P.BN256_ADD_GAS_ISTANBUL if istanbul
                    else P.BN256_ADD_GAS_BYZANTIUM)

    def required_gas(self, input_):
        return self.gas

    def run(self, input_):
        data = input_.ljust(128, b"\x00")[:128]
        a = _parse_g1(data[0:64])
        b = _parse_g1(data[64:128])
        return _encode_g1(bn256.g1_add(a, b))


class Bn256ScalarMul(Precompile):
    def __init__(self, istanbul: bool):
        self.gas = (P.BN256_SCALAR_MUL_GAS_ISTANBUL if istanbul
                    else P.BN256_SCALAR_MUL_GAS_BYZANTIUM)

    def required_gas(self, input_):
        return self.gas

    def run(self, input_):
        data = input_.ljust(96, b"\x00")[:96]
        pt = _parse_g1(data[0:64])
        k = int.from_bytes(data[64:96], "big")
        return _encode_g1(bn256.g1_mul(pt, k))


class Bn256Pairing(Precompile):
    def __init__(self, istanbul: bool):
        if istanbul:
            self.base = P.BN256_PAIRING_BASE_GAS_ISTANBUL
            self.per_point = P.BN256_PAIRING_PER_POINT_GAS_ISTANBUL
        else:
            self.base = P.BN256_PAIRING_BASE_GAS_BYZANTIUM
            self.per_point = P.BN256_PAIRING_PER_POINT_GAS_BYZANTIUM

    def required_gas(self, input_):
        return self.base + (len(input_) // 192) * self.per_point

    def run(self, input_):
        if len(input_) % 192 != 0:
            raise vmerrs.VMError("bn256: bad pairing input")
        pairs = []
        for i in range(0, len(input_), 192):
            g1 = _parse_g1(input_[i:i + 64])
            # G2: (x_imag, x_real, y_imag, y_real) big-endian
            xi = int.from_bytes(input_[i + 64:i + 96], "big")
            xr = int.from_bytes(input_[i + 96:i + 128], "big")
            yi = int.from_bytes(input_[i + 128:i + 160], "big")
            yr = int.from_bytes(input_[i + 160:i + 192], "big")
            if max(xi, xr, yi, yr) >= bn256.P:
                raise vmerrs.VMError("bn256: coord >= modulus")
            if xi == 0 and xr == 0 and yi == 0 and yr == 0:
                g2 = None
            else:
                g2 = (bn256.FQ2([xr, xi]), bn256.FQ2([yr, yi]))
                if not bn256.is_on_curve_g2(g2):
                    raise vmerrs.VMError(
                        "bn256: G2 point not on curve")
                if not bn256.g2_in_subgroup(g2):
                    raise vmerrs.VMError(
                        "bn256: G2 point not in subgroup")
            pairs.append((g1, g2))
        ok = bn256.pairing_check(pairs)
        return (1 if ok else 0).to_bytes(32, "big")


class Blake2F(Precompile):
    def required_gas(self, input_):
        if len(input_) != 213:
            return 0
        return int.from_bytes(input_[0:4], "big") * P.BLAKE2F_ROUND_GAS

    def run(self, input_):
        out = blake2f_precompile(input_)
        if out is None:
            raise vmerrs.VMError("blake2f: malformed input")
        return out


# --- Avalanche stateful precompiles ---------------------------------------

class DeprecatedContract(Precompile):
    """Always errors (contracts_stateful.go deprecatedContract)."""

    stateful = True

    def run_stateful(self, evm, caller, addr, input_, gas, read_only):
        raise vmerrs.ErrExecutionReverted("deprecated contract")


class NativeAssetBalance(Precompile):
    """0x0100..01: (address, assetID) -> balance
    (contracts_stateful_native_asset.go:29)."""

    stateful = True

    def __init__(self, gas_cost: int):
        self.gas_cost = gas_cost

    def run_stateful(self, evm, caller, addr, input_, gas, read_only):
        if gas < self.gas_cost:
            raise vmerrs.ErrOutOfGas()
        remaining = gas - self.gas_cost
        if len(input_) != 52:
            raise vmerrs.VMError("invalid input length")
        target = input_[0:20]
        asset_id = input_[20:52]
        balance = evm.statedb.get_balance_multi_coin(target, asset_id)
        return balance.to_bytes(32, "big"), remaining


class NativeAssetCall(Precompile):
    """0x0100..02: atomically transfer a multicoin asset and make a call
    (contracts_stateful_native_asset.go:75 + evm.go:710 NativeAssetCall)."""

    stateful = True

    def __init__(self, gas_cost: int):
        self.gas_cost = gas_cost

    def run_stateful(self, evm, caller, addr, input_, gas, read_only):
        return evm.native_asset_call(caller, input_, gas, self.gas_cost,
                                     read_only)


def _classic(istanbul: bool, eip2565: bool) -> Dict[bytes, Precompile]:
    return {
        ECRECOVER_ADDR: Ecrecover(),
        SHA256_ADDR: Sha256Hash(),
        RIPEMD160_ADDR: Ripemd160Hash(),
        IDENTITY_ADDR: DataCopy(),
        MODEXP_ADDR: BigModExp(eip2565),
        BN256_ADD_ADDR: Bn256Add(istanbul),
        BN256_MUL_ADDR: Bn256ScalarMul(istanbul),
        BN256_PAIRING_ADDR: Bn256Pairing(istanbul),
    }


PRECOMPILES_HOMESTEAD = {
    ECRECOVER_ADDR: Ecrecover(),
    SHA256_ADDR: Sha256Hash(),
    RIPEMD160_ADDR: Ripemd160Hash(),
    IDENTITY_ADDR: DataCopy(),
}
PRECOMPILES_BYZANTIUM = _classic(istanbul=False, eip2565=False)
PRECOMPILES_ISTANBUL = {**_classic(istanbul=True, eip2565=False),
                        BLAKE2F_ADDR: Blake2F()}
PRECOMPILES_AP2 = {
    **_classic(istanbul=True, eip2565=True),
    BLAKE2F_ADDR: Blake2F(),
    GENESIS_CONTRACT_ADDR: DeprecatedContract(),
    NATIVE_ASSET_BALANCE_ADDR: NativeAssetBalance(
        P.ASSET_BALANCE_APRICOT_GAS),
    NATIVE_ASSET_CALL_ADDR: NativeAssetCall(P.ASSET_CALL_APRICOT_GAS),
}
PRECOMPILES_PRE6 = {
    **_classic(istanbul=True, eip2565=True),
    BLAKE2F_ADDR: Blake2F(),
    GENESIS_CONTRACT_ADDR: DeprecatedContract(),
    NATIVE_ASSET_BALANCE_ADDR: DeprecatedContract(),
    NATIVE_ASSET_CALL_ADDR: DeprecatedContract(),
}
PRECOMPILES_AP6 = dict(PRECOMPILES_AP2)
PRECOMPILES_BANFF = dict(PRECOMPILES_PRE6)


def active_precompiles(rules) -> Dict[bytes, Precompile]:
    """Per-fork registry selection (contracts.go ActivePrecompiles +
    evm.go:78 precompile())."""
    if rules.is_banff:
        return PRECOMPILES_BANFF
    if rules.is_apricot_phase6:
        return PRECOMPILES_AP6
    if rules.is_apricot_phase_pre6:
        return PRECOMPILES_PRE6
    if rules.is_apricot_phase2:
        return PRECOMPILES_AP2
    if rules.is_istanbul:
        return PRECOMPILES_ISTANBUL
    if rules.is_byzantium:
        return PRECOMPILES_BYZANTIUM
    return PRECOMPILES_HOMESTEAD


def special_call_targets(rules) -> set:
    """Call targets that execute (or reject) despite having no code in
    state: classic precompiles + module-registered stateful precompiles.
    The replay classifiers must never treat these as plain transfers
    (pair with state_transition.is_prohibited for blackhole/reserved)."""
    return set(active_precompiles(rules)) | set(rules.active_precompiles)


def is_prohibited(addr: bytes) -> bool:
    """Blackhole + reserved precompile ranges (evm.go:54 IsProhibited)."""
    return addr == BLACKHOLE_ADDR or reserved_address(addr)
