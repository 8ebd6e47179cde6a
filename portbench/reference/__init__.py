"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch and NumPy path from a pair's raw views to the textured mesh.

It imports nothing of `reconstruction_tpu_torch` and nothing of the JAX
package.  The port's hand-written kernels (the NCC sweep, the banded cost
volume, the refine sweeps, the ordering and bound-propagation passes) are
replaced here by their plain versions, and its native host library
(marching tetrahedra, the cotangent Laplacian) by the NumPy versions; the
cloud stages, the Poisson solve and the texture blend are the port's plain
PyTorch, copied.  Later changes to the port leave this copy as it is: it
is what the benchmark's `correct` holds the port to.
"""
