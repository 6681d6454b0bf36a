from .async_samples_optimizer import AsyncSamplesOptimizer  # noqa: F401
from .policy_optimizer import PolicyOptimizer  # noqa: F401
from .sync_samples_optimizer import (  # noqa: F401
    MultiDeviceOptimizer, SyncSamplesOptimizer)
