"""Genesis and the value-transfer chain builder."""

from coreth_tpu_torch.chain.genesis import Genesis, GenesisAccount  # noqa: F401
from coreth_tpu_torch.chain.chain_makers import (  # noqa: F401
    BlockGen, generate_chain,
)
