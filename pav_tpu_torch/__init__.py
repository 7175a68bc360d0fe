"""pav_tpu_torch: the pav_tpu engine on PyTorch, with hand-written CUDA kernels.

The same assembly-to-reference variant caller as ``pav_tpu``: align contigs to
a reference, trim the alignments, call SNVs, indels, SVs and inversions, merge
haplotypes and write a VCF. The host stages come unchanged from the jax-free
modules of ``pav_tpu``; the modules on the device path (the affine-gap DP, its
traceback, the inversion density FFT and everything that imports them) live
here, on tensors of an explicit ``torch.device``. The DP and traceback kernels
are CUDA C++ for ``sm_90a`` (``csrc/``), built with nvcc at first use.
"""

from pav_tpu.constants import get_version_string

__version__ = get_version_string()
