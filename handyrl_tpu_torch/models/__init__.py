from .wrapper import (  # noqa: F401
    RandomModel,
    TorchModel,
    load_params,
    snapshot_params,
)
