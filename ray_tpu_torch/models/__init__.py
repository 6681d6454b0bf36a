from .catalog import MODEL_DEFAULTS, get_model, get_preprocessor  # noqa: F401
from .distributions import Categorical, get_action_dist  # noqa: F401
from .networks import (  # noqa: F401
    FullyConnectedNetwork, QNetwork, VisionNetwork)
