"""Atomic transaction types: ImportTx / ExportTx.

Port of reference ``atomic/tx.py``: the same wire bytes, tx ids, fees
and state transfers.

Twin of reference plugin/evm/tx.go (:52 EVMOutput, :67 EVMInput, :113
UnsignedAtomicTx, :195 BlockFeeContribution, :252 CalculateDynamicFee),
import_tx.go and export_tx.go.  Signatures are 65-byte [R||S||V]
secp256k1 over sha256 of the unsigned tx bytes (secp256k1fx); UTXO
owners are avalanchego short ids = ripemd160(sha256(compressed pub)).

AVAX amounts on the UTXO side are nAVAX (9 decimals); EVM balances are
wei (18) — conversions multiply/divide by X2C_RATE (tx.go x2cRate).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from coreth_tpu_torch.wire import (
    CODEC_VERSION, Packer, TYPE_EXPORT_TX, TYPE_IMPORT_TX,
    TYPE_SECP_CREDENTIAL, TYPE_SECP_TRANSFER_INPUT,
    TYPE_SECP_TRANSFER_OUTPUT, Unpacker,
)
from coreth_tpu_torch.crypto import secp256k1 as secp

X2C_RATE = 10**9
X2C_RATE_MINUS_1 = X2C_RATE - 1

# gas cost model (tx.go:46-48, params AtomicTxBaseCost)
TX_BYTES_GAS = 1
EVM_OUTPUT_GAS = 20 + 8 + 32
COST_PER_SIGNATURE = 1000  # secp256k1fx.CostPerSignature
EVM_INPUT_GAS = (20 + 8 + 32 + 8) + COST_PER_SIGNATURE
ATOMIC_TX_BASE_COST = 10_000  # params.AtomicTxBaseCost (AP5 fixed fee)


class AtomicTxError(Exception):
    pass


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def short_id(pubkey: Tuple[int, int]) -> bytes:
    """avalanchego address: ripemd160(sha256(33-byte compressed pub))."""
    x, y = pubkey
    comp = bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
    h = hashlib.new("ripemd160")
    h.update(sha256(comp))
    return h.digest()


def calculate_dynamic_fee(cost: int, base_fee: Optional[int]) -> int:
    """nAVAX fee for `cost` gas at `base_fee` wei (tx.go:252)."""
    if base_fee is None:
        raise AtomicTxError("nil base fee")
    return (cost * base_fee + X2C_RATE_MINUS_1) // X2C_RATE


def utxo_id(tx_id: bytes, output_index: int) -> bytes:
    """UTXO id: sha256(txID ++ outputIndex) (avax.UTXOID.InputID)."""
    p = Packer()
    p.fixed(tx_id, 32)
    p.u32(output_index)
    return sha256(p.bytes())


# ------------------------------------------------------------------ UTXO

@dataclass
class TransferableOutput:
    """avax.TransferableOutput with a secp256k1fx.TransferOutput."""
    asset_id: bytes = b"\x00" * 32
    amount: int = 0
    locktime: int = 0
    threshold: int = 1
    addrs: List[bytes] = field(default_factory=list)  # 20-byte short ids

    def pack(self, p: Packer) -> None:
        p.fixed(self.asset_id, 32)
        p.u32(TYPE_SECP_TRANSFER_OUTPUT)
        p.u64(self.amount)
        p.u64(self.locktime)
        p.u32(self.threshold)
        p.u32(len(self.addrs))
        for a in self.addrs:
            p.fixed(a, 20)

    @classmethod
    def unpack(cls, u: Unpacker) -> "TransferableOutput":
        asset_id = u.fixed(32)
        if u.u32() != TYPE_SECP_TRANSFER_OUTPUT:
            raise AtomicTxError("bad output type")
        amount = u.u64()
        locktime = u.u64()
        threshold = u.u32()
        addrs = [u.fixed(20) for _ in range(u.u32())]
        return cls(asset_id, amount, locktime, threshold, addrs)


@dataclass
class TransferableInput:
    """avax.TransferableInput with a secp256k1fx.TransferInput."""
    tx_id: bytes = b"\x00" * 32
    output_index: int = 0
    asset_id: bytes = b"\x00" * 32
    amount: int = 0
    sig_indices: List[int] = field(default_factory=list)

    def input_id(self) -> bytes:
        return utxo_id(self.tx_id, self.output_index)

    def cost(self) -> int:
        return COST_PER_SIGNATURE * len(self.sig_indices)

    def pack(self, p: Packer) -> None:
        p.fixed(self.tx_id, 32)
        p.u32(self.output_index)
        p.fixed(self.asset_id, 32)
        p.u32(TYPE_SECP_TRANSFER_INPUT)
        p.u64(self.amount)
        p.u32(len(self.sig_indices))
        for i in self.sig_indices:
            p.u32(i)

    @classmethod
    def unpack(cls, u: Unpacker) -> "TransferableInput":
        tx_id = u.fixed(32)
        output_index = u.u32()
        asset_id = u.fixed(32)
        if u.u32() != TYPE_SECP_TRANSFER_INPUT:
            raise AtomicTxError("bad input type")
        amount = u.u64()
        sig_indices = [u.u32() for _ in range(u.u32())]
        return cls(tx_id, output_index, asset_id, amount, sig_indices)


@dataclass
class UTXO:
    """A spendable output resident in shared memory."""
    tx_id: bytes
    output_index: int
    out: TransferableOutput

    def input_id(self) -> bytes:
        return utxo_id(self.tx_id, self.output_index)

    def encode(self) -> bytes:
        p = Packer()
        p.u16(CODEC_VERSION)
        p.fixed(self.tx_id, 32)
        p.u32(self.output_index)
        self.out.pack(p)
        return p.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "UTXO":
        u = Unpacker(data)
        if u.u16() != CODEC_VERSION:
            raise AtomicTxError("bad codec version")
        tx_id = u.fixed(32)
        output_index = u.u32()
        return cls(tx_id, output_index, TransferableOutput.unpack(u))


# ------------------------------------------------------------ EVM in/out

@dataclass
class EVMOutput:
    """EVM-side credit (tx.go:52)."""
    address: bytes = b"\x00" * 20
    amount: int = 0          # nAVAX (or native asset units)
    asset_id: bytes = b"\x00" * 32

    def pack(self, p: Packer) -> None:
        p.fixed(self.address, 20)
        p.u64(self.amount)
        p.fixed(self.asset_id, 32)

    @classmethod
    def unpack(cls, u: Unpacker) -> "EVMOutput":
        return cls(u.fixed(20), u.u64(), u.fixed(32))


@dataclass
class EVMInput:
    """EVM-side debit, nonce-guarded (tx.go:67)."""
    address: bytes = b"\x00" * 20
    amount: int = 0
    asset_id: bytes = b"\x00" * 32
    nonce: int = 0

    def input_id(self) -> bytes:
        """hash(address:nonce) pseudo-UTXO id (export_tx.go:55-64)."""
        raw = bytearray(32)
        raw[0:8] = self.nonce.to_bytes(8, "big")
        raw[8:12] = (20).to_bytes(4, "big")
        raw[12:32] = self.address
        return bytes(raw)

    def pack(self, p: Packer) -> None:
        p.fixed(self.address, 20)
        p.u64(self.amount)
        p.fixed(self.asset_id, 32)
        p.u64(self.nonce)

    @classmethod
    def unpack(cls, u: Unpacker) -> "EVMInput":
        return cls(u.fixed(20), u.u64(), u.fixed(32), u.u64())


# -------------------------------------------------------------- the txs

@dataclass
class UnsignedImportTx:
    """import_tx.go:39."""
    network_id: int = 0
    blockchain_id: bytes = b"\x00" * 32
    source_chain: bytes = b"\x00" * 32
    imported_inputs: List[TransferableInput] = field(default_factory=list)
    outs: List[EVMOutput] = field(default_factory=list)

    type_id = TYPE_IMPORT_TX

    def pack_fields(self, p: Packer) -> None:
        p.u32(self.network_id)
        p.fixed(self.blockchain_id, 32)
        p.fixed(self.source_chain, 32)
        p.u32(len(self.imported_inputs))
        for i in self.imported_inputs:
            i.pack(p)
        p.u32(len(self.outs))
        for o in self.outs:
            o.pack(p)

    @classmethod
    def unpack_fields(cls, u: Unpacker) -> "UnsignedImportTx":
        network_id = u.u32()
        blockchain_id = u.fixed(32)
        source_chain = u.fixed(32)
        ins = [TransferableInput.unpack(u) for _ in range(u.u32())]
        outs = [EVMOutput.unpack(u) for _ in range(u.u32())]
        return cls(network_id, blockchain_id, source_chain, ins, outs)

    # --------------------------------------------------------- semantics
    def verify(self, ctx) -> None:
        if not self.imported_inputs:
            raise AtomicTxError("no import inputs")
        if self.network_id != ctx.network_id:
            raise AtomicTxError("wrong network id")
        if self.blockchain_id != ctx.chain_id:
            raise AtomicTxError("wrong blockchain id")

    def input_utxos(self) -> List[bytes]:
        return [i.input_id() for i in self.imported_inputs]

    def gas_used(self, fixed_fee: bool, tx_bytes_len: int) -> int:
        cost = tx_bytes_len * TX_BYTES_GAS
        for i in self.imported_inputs:
            cost += i.cost()
        if fixed_fee:
            cost += ATOMIC_TX_BASE_COST
        return cost

    def burned(self, asset_id: bytes) -> int:
        spent = sum(o.amount for o in self.outs
                    if o.asset_id == asset_id)
        inp = sum(i.amount for i in self.imported_inputs
                  if i.asset_id == asset_id)
        if inp < spent:
            raise AtomicTxError("import burned underflow")
        return inp - spent

    def evm_state_transfer(self, ctx, statedb) -> None:
        """import_tx.go:431 EVMStateTransfer."""
        for out in self.outs:
            if out.asset_id == ctx.avax_asset_id:
                statedb.add_balance(out.address, out.amount * X2C_RATE)
            else:
                statedb.add_balance_multi_coin(
                    out.address, out.asset_id, out.amount)

    def atomic_ops(self, tx_id: bytes):
        """(chain, puts, removes): imports REMOVE consumed UTXOs from
        the source chain's shared memory (atomic_backend semantics)."""
        removes = [i.input_id() for i in self.imported_inputs]
        return self.source_chain, [], removes


@dataclass
class UnsignedExportTx:
    """export_tx.go:39."""
    network_id: int = 0
    blockchain_id: bytes = b"\x00" * 32
    destination_chain: bytes = b"\x00" * 32
    ins: List[EVMInput] = field(default_factory=list)
    exported_outputs: List[TransferableOutput] = field(default_factory=list)

    type_id = TYPE_EXPORT_TX

    def pack_fields(self, p: Packer) -> None:
        p.u32(self.network_id)
        p.fixed(self.blockchain_id, 32)
        p.fixed(self.destination_chain, 32)
        p.u32(len(self.ins))
        for i in self.ins:
            i.pack(p)
        p.u32(len(self.exported_outputs))
        for o in self.exported_outputs:
            o.pack(p)

    @classmethod
    def unpack_fields(cls, u: Unpacker) -> "UnsignedExportTx":
        network_id = u.u32()
        blockchain_id = u.fixed(32)
        destination_chain = u.fixed(32)
        ins = [EVMInput.unpack(u) for _ in range(u.u32())]
        outs = [TransferableOutput.unpack(u) for _ in range(u.u32())]
        return cls(network_id, blockchain_id, destination_chain, ins, outs)

    # --------------------------------------------------------- semantics
    def verify(self, ctx) -> None:
        if not self.exported_outputs:
            raise AtomicTxError("no export outputs")
        if self.network_id != ctx.network_id:
            raise AtomicTxError("wrong network id")
        if self.blockchain_id != ctx.chain_id:
            raise AtomicTxError("wrong blockchain id")

    def input_utxos(self) -> List[bytes]:
        return [i.input_id() for i in self.ins]

    def gas_used(self, fixed_fee: bool, tx_bytes_len: int) -> int:
        cost = tx_bytes_len * TX_BYTES_GAS
        cost += len(self.ins) * EVM_INPUT_GAS
        for o in self.exported_outputs:
            cost += EVM_OUTPUT_GAS  # approximation of out serialization
        if fixed_fee:
            cost += ATOMIC_TX_BASE_COST
        return cost

    def burned(self, asset_id: bytes) -> int:
        spent = sum(o.amount for o in self.exported_outputs
                    if o.asset_id == asset_id)
        inp = sum(i.amount for i in self.ins if i.asset_id == asset_id)
        if inp < spent:
            raise AtomicTxError("export burned underflow")
        return inp - spent

    def evm_state_transfer(self, ctx, statedb) -> None:
        """export_tx.go:372 EVMStateTransfer: debit + nonce guard."""
        for inp in self.ins:
            if inp.asset_id == ctx.avax_asset_id:
                amount = inp.amount * X2C_RATE
                if statedb.get_balance(inp.address) < amount:
                    raise AtomicTxError("insufficient funds")
                statedb.sub_balance(inp.address, amount)
            else:
                if statedb.get_balance_multi_coin(
                        inp.address, inp.asset_id) < inp.amount:
                    raise AtomicTxError("insufficient funds")
                statedb.sub_balance_multi_coin(
                    inp.address, inp.asset_id, inp.amount)
            if statedb.get_nonce(inp.address) != inp.nonce:
                raise AtomicTxError("invalid nonce")
            statedb.set_nonce(inp.address, inp.nonce + 1)

    def atomic_ops(self, tx_id: bytes):
        """Exports PUT new UTXOs into the destination chain's inbox."""
        puts = []
        for idx, out in enumerate(self.exported_outputs):
            utxo = UTXO(tx_id, idx, out)
            puts.append((utxo.input_id(), utxo.encode(), out.addrs))
        return self.destination_chain, puts, []


@dataclass
class Tx:
    """Signed atomic tx: unsigned + one credential (list of 65-byte
    sigs) per input (tx.go:290 shape)."""
    unsigned: object = None
    creds: List[List[bytes]] = field(default_factory=list)

    def unsigned_bytes(self) -> bytes:
        p = Packer()
        p.u16(CODEC_VERSION)
        p.u32(self.unsigned.type_id)
        self.unsigned.pack_fields(p)
        return p.bytes()

    def encode(self) -> bytes:
        p = Packer()
        p.u16(CODEC_VERSION)
        p.u32(self.unsigned.type_id)
        self.unsigned.pack_fields(p)
        p.u32(len(self.creds))
        for sigs in self.creds:
            p.u32(TYPE_SECP_CREDENTIAL)
            p.u32(len(sigs))
            for sig in sigs:
                p.fixed(sig, 65)
        return p.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Tx":
        u = Unpacker(data)
        if u.u16() != CODEC_VERSION:
            raise AtomicTxError("bad codec version")
        type_id = u.u32()
        if type_id == TYPE_IMPORT_TX:
            unsigned = UnsignedImportTx.unpack_fields(u)
        elif type_id == TYPE_EXPORT_TX:
            unsigned = UnsignedExportTx.unpack_fields(u)
        else:
            raise AtomicTxError(f"unknown atomic tx type {type_id}")
        creds = []
        for _ in range(u.u32()):
            if u.u32() != TYPE_SECP_CREDENTIAL:
                raise AtomicTxError("bad credential type")
            creds.append([u.fixed(65) for _ in range(u.u32())])
        return cls(unsigned, creds)

    def id(self) -> bytes:
        return sha256(self.encode())

    def sign(self, keys: List[List[int]]) -> None:
        """One key list per input; sigs over sha256(unsigned bytes)."""
        digest = sha256(self.unsigned_bytes())
        self.creds = []
        for key_list in keys:
            sigs = []
            for priv in key_list:
                r, s, recid = secp.sign(digest, priv)
                sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big")
                            + bytes([recid]))
            self.creds.append(sigs)

    def _recover(self, to_addr) -> List[List[bytes]]:
        digest = sha256(self.unsigned_bytes())
        out = []
        for sigs in self.creds:
            addrs = []
            for sig in sigs:
                r = int.from_bytes(sig[0:32], "big")
                s = int.from_bytes(sig[32:64], "big")
                pub = secp.recover_pubkey(digest, r, s, sig[64])
                addrs.append(to_addr(pub))
            out.append(addrs)
        return out

    def recover_signers(self) -> List[List[bytes]]:
        """Short-id addresses recovered per credential (UTXO owners)."""
        return self._recover(short_id)

    def recover_eth_signers(self) -> List[List[bytes]]:
        """ETH addresses recovered per credential (EVM input owners)."""
        return self._recover(secp.pubkey_to_address)

    # ---------------------------------------------------------- fee hook
    def block_fee_contribution(self, fixed_fee: bool, avax_asset_id: bytes,
                               base_fee: int):
        """(contribution_wei, gas_used) — tx.go:195."""
        gas_used = self.unsigned.gas_used(fixed_fee, len(self.encode()))
        tx_fee = calculate_dynamic_fee(gas_used, base_fee)
        burned = self.unsigned.burned(avax_asset_id)
        if tx_fee > burned:
            raise AtomicTxError(
                f"insufficient AVAX burned ({burned}) to cover fee "
                f"({tx_fee})")
        return (burned - tx_fee) * X2C_RATE, gas_used


def encode_ext_data(txs: List[Tx]) -> bytes:
    """Block ExtData payload: codec version + tx array."""
    p = Packer()
    p.u16(CODEC_VERSION)
    p.u32(len(txs))
    for tx in txs:
        p.var_bytes(tx.encode())
    return p.bytes()


def decode_ext_data(data: bytes) -> List[Tx]:
    if not data:
        return []
    u = Unpacker(data)
    if u.u16() != CODEC_VERSION:
        raise AtomicTxError("bad codec version")
    return [Tx.decode(u.var_bytes()) for _ in range(u.u32())]
