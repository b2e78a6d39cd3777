"""qp_zk_circuits_tpu_torch — the PyTorch/CUDA port of qp_zk_circuits_tpu.

The same Plonky2-class prover (Goldilocks field, Poseidon2, NTT/LDE, Merkle
caps, PLONK with FRI) and Wormhole leaf layer, for one NVIDIA H100. Device
work runs in hand-written CUDA kernels (csrc/, built with nvcc for sm_90a at
first use); each kernel's wrapper runs a plain PyTorch version of it for CPU
tensors. The package imports torch and numpy, never jax, and nothing from
qp_zk_circuits_tpu. Layout mirrors the JAX package:

  field/     Goldilocks on int64 tensors (kernel 1) + numpy host oracle + D=2 extension
  hash/      Poseidon2 (kernel 2), Merkle trees with caps, keccak256 (host)
  poly/      batched NTT / iNTT / coset LDE (kernel 3)
  fri/       oracles (commit, openings), FRI prover and verifier
  plonk/     builder, gates, transcript, prover (and its warm start), verifier,
             serialization
  recursion/ the in-circuit verifier: extension gadgets, challenger, verifier
  utils/     byte<->felt codecs, config policy, gadgets
  wormhole/  the Wormhole leaf circuit, WormholeProver, WormholeVerifier, the
             private and public batch layers, dummy and fake leaves, and the
             pinned artifact set
  models/    the provers re-exported under one roof
  native/    the host's work in C (Poseidon2, transcript absorb, witness
             tape, constraint tape, FRI query verifier), built with the
             system C compiler at first use

The verifiers run on the host.
"""

__version__ = "0.1.0"
