from .sac import DEFAULT_CONFIG, SACTrainer  # noqa: F401
from .sac_policy import SACPolicy  # noqa: F401
