"""The device step machine (K5) and its host adapter."""
