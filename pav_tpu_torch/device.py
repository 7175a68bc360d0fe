"""The one device choice of a run, made explicitly at the entry point.

There is no probe of a default backend: the caller names the device (CLI
``--device``, config key ``device``, default ``cuda``), and a run that asks
for CUDA on a host without it stops instead of carrying on on the CPU.
"""

import torch

DEFAULT_DEVICE = 'cuda'


def resolve_device(device=None):
    """``torch.device`` for a name or device; ``None`` means ``cuda``.

    :raises RuntimeError: CUDA was asked for and ``torch.cuda.is_available()``
        is false.
    :raises ValueError: a device type other than ``cuda`` or ``cpu``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'device {str(dev)!r} requested but torch.cuda.is_available() '
                'is false; pass --device cpu to run on the CPU')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {str(dev)!r} (cuda or cpu)')
    return dev
