from .env import CartPole, Env, SyntheticAtari  # noqa: F401
from .registry import (make_batched_env, make_env,  # noqa: F401
                       register_batched_env, register_env)
from .spaces import Box, Discrete, Space  # noqa: F401
from .vector_env import VectorEnv  # noqa: F401
