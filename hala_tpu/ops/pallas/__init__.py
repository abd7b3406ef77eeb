"""Pallas kernels (through Triton) for the hot paths (the hand-written-SPIR-V
equivalent layer). Everything here has a pure-jnp reference
implementation elsewhere in ops/ that it is validated against."""
