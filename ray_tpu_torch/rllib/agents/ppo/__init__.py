from .ppo import DEFAULT_CONFIG, PPOTorchPolicy, PPOTrainer  # noqa: F401
