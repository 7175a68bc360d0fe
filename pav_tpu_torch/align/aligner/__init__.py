"""Native contig-to-reference aligner of the torch port: minimizer seeding,
chaining, banded affine-gap extension (CUDA DP kernels), =/X CIGAR emission.
"""

from .core import Aligner  # noqa: F401
