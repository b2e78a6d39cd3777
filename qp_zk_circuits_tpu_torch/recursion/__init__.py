"""Recursive verification: in-circuit FRI/PLONK verifier gadgets (the JAX
package's `recursion/`).

The capability behind the reference's `add_recursive_verifiers`
(`aggregator/src/common/recursive.rs:74-102`): verify inner proofs inside an
outer circuit, with the inner verifier key baked as constants
(anti-substitution; the unsafe virtual-VK variant is documented as an attack
in `recursive.rs:14-28` and deliberately not provided here). The gadgets
build circuits on the host and do no device work."""
