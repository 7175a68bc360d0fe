"""pav_tpu_torch: the pav_tpu engine on PyTorch, with hand-written CUDA kernels.

The same assembly-to-reference variant caller as ``pav_tpu``: align contigs to
a reference, trim the alignments, call SNVs, indels, SVs and inversions, merge
haplotypes and write a VCF. The port carries its own copy of every host
module it runs (sequence codec, I/O, alignment tables, trimming, callers,
merging, VCF) at the same relative path as in ``pav_tpu``, and imports
nothing of ``pav_tpu``. The modules on the device path (the affine-gap DP, its
traceback, the inversion density FFT and everything that imports them) run
on tensors of an explicit ``torch.device``. The DP, traceback and chain scan
kernels are CUDA C++ for ``sm_90a`` (``csrc/``), built with nvcc at first use.
"""

from .constants import get_version_string

__version__ = get_version_string()
