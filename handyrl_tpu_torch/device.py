"""Device selection: explicit, with no hidden fallback.

Every entry point of the port takes a ``device`` argument whose
default is ``"cuda"``.  Asking for the card on a machine without one
is an error, never a quiet switch to the CPU: a run that silently
lands on the CPU would report CPU numbers under the card's name.
Tests and CPU-side child processes pass ``"cpu"`` explicitly.
"""

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(name=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu").

    Raises RuntimeError when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is False, and ValueError for any
    other device type."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(
            f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} was requested but CUDA is not available "
            f"(torch {torch.__version__}); pass device='cpu' to run "
            f"on the CPU")
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {name!r} was requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) exist")
    return device


def pop_device_arg(argv):
    """Split ``--device DEV`` / ``--device=DEV`` out of a command line:
    ``(device, the other arguments)``, the device ``cuda`` if absent."""
    device, rest = DEFAULT_DEVICE, []
    it = iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value (cuda or cpu)")
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return device, rest
