"""EVM host tables, bytecode analysis and the device step machine."""
