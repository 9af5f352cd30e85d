"""Tensor ops of the port: 256-bit limb math and ALU, keccak, the secp256k1 ladder."""
