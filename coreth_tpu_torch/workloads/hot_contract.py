"""Single-hot-contract workload: one ERC-20-shaped contract takes every
transaction.

Port of reference ``workloads/hot_contract.py`` on the port's chain
builder and state store.  The contract is the ``workloads/erc20`` token
runtime; senders and recipients are drawn from independent Zipf
distributions (a few heavy senders and recipients over a long tail of
one-off users).  On a sharded engine this is the shape that puts every
lane on the one contract's shard under contract-bucket placement, and
that key-range placement spreads over the shards.

Everything is deterministic (a fixed-seed 64-bit LCG drives the Zipf
draws), so two builds of the same shape, by either package, give the
same chain.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Callable, List

from coreth_tpu_torch.workloads.erc20 import TOKEN_RUNTIME, transfer_calldata

# the one hot contract's address
HOT_CONTRACT = b"\x79" * 20
HOT_RUNTIME = TOKEN_RUNTIME

_M64 = (1 << 64) - 1


def _lcg(seed: int) -> Callable[[], int]:
    """Deterministic 64-bit LCG (Knuth MMIX constants)."""
    state = (seed ^ 0x9E3779B97F4A7C15) & _M64 or 1

    def nxt() -> int:
        nonlocal state
        state = (state * 6364136223846793005
                 + 1442695040888963407) & _M64
        return state >> 11

    return nxt


def zipf_sampler(n: int, alpha: float, seed: int) -> Callable[[], int]:
    """Sampler over ranks [0, n) with P(i) ~ 1/(i+1)^alpha, by CDF
    inversion over a fixed-seed LCG."""
    weights: List[float] = []
    acc = 0.0
    for i in range(n):
        acc += 1.0 / float(i + 1) ** alpha
        weights.append(acc)
    total = weights[-1]
    rnd = _lcg(seed)

    def draw() -> int:
        u = (rnd() / float(1 << 53)) * total
        return min(n - 1, bisect_right(weights, u))

    return draw


def recipient_pool(addrs, extra: int) -> List[bytes]:
    """The funded holders plus ``extra`` synthetic one-off addresses
    (fresh balance slots)."""
    pool = list(addrs)
    for i in range(extra):
        pool.append(b"\x9a" + i.to_bytes(4, "big") * 4 + b"\x9a" * 3)
    return pool


def hot_genesis_alloc(addrs) -> dict:
    """Gas-funded senders, all token balance pre-minted to them on the
    hot contract."""
    from coreth_tpu_torch.chain import GenesisAccount
    from coreth_tpu_torch.workloads.erc20 import token_genesis_account
    alloc = {a: GenesisAccount(balance=10**27) for a in addrs}
    alloc[HOT_CONTRACT] = token_genesis_account({a: 10**24 for a in addrs})
    return alloc


def hot_tx_gen(keys, addrs, txs_per_block: int, nonces,
               *, chain_id: int, alpha: float = 1.1,
               seed: int = 20260804, extra_recipients: int = 0,
               gas: int = 200_000):
    """A ``gen(i, bg)`` for ``generate_chain``: every tx a transfer() into
    ``HOT_CONTRACT``, sender and recipient from independent Zipf draws."""
    from coreth_tpu_torch.types import DynamicFeeTx, sign_tx
    gwei = 10**9
    pool = recipient_pool(addrs, extra_recipients
                          or max(16, 2 * len(addrs)))
    senders = zipf_sampler(len(keys), alpha, seed)
    recips = zipf_sampler(len(pool), alpha, seed ^ 0x5BD1E995)

    def gen(i, bg):
        for j in range(txs_per_block):
            k = senders()
            to = pool[recips()]
            bg.add_tx(sign_tx(DynamicFeeTx(
                chain_id_=chain_id, nonce=nonces[k],
                gas_tip_cap_=gwei, gas_fee_cap_=2000 * gwei, gas=gas,
                to=HOT_CONTRACT, value=0,
                data=transfer_calldata(to, 1 + (i * 31 + j) % 97),
            ), keys[k], chain_id))
            nonces[k] += 1

    return gen


def hot_genesis(config, n_keys: int, *, key_base: int = 0xA11CE0,
                gas_limit: int = 30_000_000):
    """(genesis, keys, addrs) of the workload."""
    from coreth_tpu_torch.chain import Genesis
    from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
    keys = [key_base + i for i in range(n_keys)]
    addrs = [priv_to_address(k) for k in keys]
    genesis = Genesis(config=config, gas_limit=gas_limit,
                      alloc=hot_genesis_alloc(addrs))
    return genesis, keys, addrs


def build_hot_chain(config, n_blocks: int, txs_per_block: int,
                    n_keys: int = 64, *, alpha: float = 1.1,
                    seed: int = 20260804, gas_limit: int = 30_000_000,
                    key_base: int = 0xA11CE0):
    """(genesis, blocks) of the single-hot-contract chain, gap 10."""
    from coreth_tpu_torch.chain import generate_chain
    from coreth_tpu_torch.state import StateStore
    genesis, keys, addrs = hot_genesis(config, n_keys, key_base=key_base,
                                       gas_limit=gas_limit)
    store = StateStore()
    gblock = genesis.to_block(store)
    nonces = [0] * n_keys
    gen = hot_tx_gen(keys, addrs, txs_per_block, nonces,
                     chain_id=config.chain_id, alpha=alpha, seed=seed)
    blocks, _ = generate_chain(config, gblock, store, n_blocks, gen,
                               gap=10)
    return genesis, blocks
