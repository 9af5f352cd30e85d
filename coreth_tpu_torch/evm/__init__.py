"""EVM facts the transfer classifier needs (no interpreter in this slice)."""
