"""Batched device transforms in plain jnp, compiled by XLA.

Every op here is shape-static, batched over a leading frame/tile/block
dimension, and runs under jit on the accelerator, with identical
semantics on the CPU backend used by the test mesh.
"""
