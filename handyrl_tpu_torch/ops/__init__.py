from .targets import (  # noqa: F401
    compute_target,
    impact,
    monte_carlo,
    temporal_difference,
    upgo,
    vtrace,
)
