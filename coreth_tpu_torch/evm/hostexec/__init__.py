"""The native host execution session (``native/evm.cc`` coreth_hostexec_*)."""
