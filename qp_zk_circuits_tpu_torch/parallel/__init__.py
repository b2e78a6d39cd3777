"""Device meshes and sharded prover steps (the JAX package's `parallel/`):
the mesh, its two collectives, the tensor-parallel commit and the
data-parallel batch."""
