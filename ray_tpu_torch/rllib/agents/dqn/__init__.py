from .dqn import (DEFAULT_CONFIG, SIMPLE_Q_CONFIG, DQNTrainer,  # noqa: F401
                  SimpleQTrainer)
from .dqn_policy import DQNPolicy  # noqa: F401
