"""The port stands alone: importing it, and training IMPALA with a
remote worker on its local-mode runtime and on its multi-process runtime
(the worker's own process included, started through the worker entry
point `ray_tpu_torch._private.default_worker`), loads no JAX, no
`ray_tpu`, no `cloudpickle` and no `lz4`; asking for the card where
there is none raises instead of falling back to the CPU. The import
check runs in a fresh interpreter (this test process has JAX loaded by
the JAX package's tests)."""

import os
import subprocess
import sys

import jax  # noqa: F401  (the JAX package's tests share this process)
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BANNED = ("jax", "jaxlib", "flax", "optax", "ray_tpu", "cloudpickle", "lz4")

_PROBE = f"BANNED = {_BANNED!r}\n" + """
import sys
import ray_tpu_torch
import ray_tpu_torch.rllib.agents.impala
import ray_tpu_torch.models.convert
import ray_tpu_torch.rllib.env.batched_env
import ray_tpu_torch.rllib.env.delta_obs
import ray_tpu_torch.rllib.env.device_frame_stack
import ray_tpu_torch.rllib.evaluation.device_sampler
import ray_tpu_torch.rllib.optimizers.async_samples_optimizer
import ray_tpu_torch.rllib.env.device_env
import ray_tpu_torch.rllib.optimizers.anakin_optimizer
import ray_tpu_torch._private.serialization
import ray_tpu_torch.parallel.collectives
import ray_tpu_torch.parallel.distributed
import ray_tpu_torch.parallel.mesh
import ray_tpu_torch.parallel.q8_check
import ray_tpu_torch.rllib.agents.ppo
import ray_tpu_torch.rllib.optimizers.sync_samples_optimizer
import ray_tpu_torch.rllib.agents.dqn
import ray_tpu_torch.rllib.agents.dqn.dqn_policy
import ray_tpu_torch.models.eps_greedy
import ray_tpu_torch.rllib.optimizers.replay_buffer
import ray_tpu_torch.rllib.optimizers.segment_tree
import ray_tpu_torch.rllib.optimizers.sync_replay_optimizer
import ray_tpu_torch.rllib.utils.schedules
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
import ray_tpu_torch.rllib.agents.sac
import ray_tpu_torch.rllib.agents.sac.sac_policy
import ray_tpu_torch.rllib.agents.registry
import ray_tpu_torch._private.local_mode
import ray_tpu_torch._private.weight_sync
import ray_tpu_torch.rllib.utils.weight_broadcast
import ray_tpu_torch.rllib.evaluation.worker_set
import ray_tpu_torch._private.default_worker
import ray_tpu_torch._private.head
import ray_tpu_torch._private.node
import ray_tpu_torch._private.object_store
import ray_tpu_torch._private.protocol
import ray_tpu_torch._private.runtime
import ray_tpu_torch._private.task_spec
from ray_tpu_torch.rllib.agents.registry import get_trainer_class
get_trainer_class("SAC")
from ray_tpu_torch.rllib.agents.sac import SACPolicy
SACPolicy(Box(-1.0, 1.0, (3,)), Box(-2.0, 2.0, (1,)),
          {"device": "cpu", "pure_exploration_steps": 0}) \
    .compute_actions([[0.0, 0.0, 0.0]])
from ray_tpu_torch.rllib.env import make_batched_env
from ray_tpu_torch.rllib.env.registry import make_env
make_env("Pendulum-v0").reset()
from ray_tpu_torch.rllib.agents.dqn import DQNPolicy
DQNPolicy(Box(-1.0, 1.0, (4,)), Discrete(2), {"device": "cpu"}) \
    .compute_actions([[0.0, 0.0, 0.0, 0.0]])
make_batched_env("SpriteAtari-v0", 2, device_frame_stack=4, seed=0)
env = ray_tpu_torch.rllib.env.device_env.DeviceSyntheticAtari()
env.reset(2, seed=0, device="cpu")
ray_tpu_torch.parallel.q8_check.check_encode(2, seed=0, device="cpu")
ray_tpu_torch.init(local_mode=True)
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
t = IMPALATrainer(config={"env": "CartPole-v0", "num_workers": 1,
                          "rollout_fragment_length": 10,
                          "train_batch_size": 20, "min_iter_time_s": 0,
                          "model": {"fcnet_hiddens": [8]}, "device": "cpu"})
t.train()
t.stop()
ray_tpu_torch.shutdown()
# The multi-process runtime: the worker is a process of its own.
sys.path.insert(0, "tests")
import torch_runtime_program
ray_tpu_torch.init(num_cpus=2)
t = IMPALATrainer(config={"env": "CartPole-v0", "num_workers": 1,
                          "rollout_fragment_length": 10,
                          "train_batch_size": 20, "min_iter_time_s": 0,
                          "model": {"fcnet_hiddens": [8]}, "device": "cpu"})
t.train()
w = t.workers.remote_workers[0]
info = ray_tpu_torch.get(w.apply.remote(
    torch_runtime_program.rollout_worker_process, list(BANNED)))
assert info["pid"] != __import__("os").getpid(), info
print("WORKER_BANNED=" + ",".join(info["modules"]))
t.stop()
ray_tpu_torch.shutdown()
banned = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
print("BANNED=" + ",".join(banned))
"""


def test_import_loads_no_jax_and_no_ray_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "WORKER_BANNED=\n" in out.stdout, out.stdout
    assert "\nBANNED=\n" in out.stdout, out.stdout


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card "
                    "error path")


def test_cuda_without_a_card_raises(no_card):
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    # The trainer's default device is "cuda": construction raises.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IMPALATrainer(config={"env": "CartPole-v0"})
    from ray_tpu_torch.rllib.agents.ppo import PPOTrainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOTrainer(config={"env": "Pendulum-v0"})
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def test_dqn_without_a_card_raises(no_card):
    from ray_tpu_torch.rllib.agents.dqn import DQNTrainer, SimpleQTrainer
    for cls in (DQNTrainer, SimpleQTrainer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(config={"env": "CartPole-v0"})


def test_sac_without_a_card_raises(no_card):
    """SACTrainer and SACPolicy default to the card."""
    from ray_tpu_torch.rllib.agents.sac import SACPolicy, SACTrainer
    from ray_tpu_torch.rllib.env.spaces import Box
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SACTrainer(config={"env": "Pendulum-v0"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SACPolicy(Box(-1.0, 1.0, (3,)), Box(-1.0, 1.0, (1,)), {})


_SMOKE_PROBE = f"BANNED = {_BANNED!r}\n" + """
import sys
sys.argv[1:] = sys.argv[2:]
import chip_smoke
chip_smoke.port_kernels()
import ray_tpu_torch.rllib.agents.dqn
import ray_tpu_torch.rllib.agents.sac
import ray_tpu_torch.rllib.utils.weight_broadcast
banned = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
print("BANNED=" + ",".join(banned))
sys.exit(chip_smoke.main())
"""


@pytest.mark.parametrize("mode", [[], ["workers"], ["procs"]],
                         ids=["all-phases", "workers", "procs"])
def test_chip_smoke_loads_no_jax_and_needs_a_card(no_card, mode):
    """`chip_smoke.py` and the port modules it drives load no JAX, no
    `ray_tpu`, no `cloudpickle` and no `lz4`; without a card the script
    exits non-zero and prints no result line (with no argument and in
    its `workers` and `procs` modes)."""
    out = subprocess.run(
        [sys.executable, "-c", _SMOKE_PROBE, "--", *mode], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert "BANNED=\n" in out.stdout, out.stdout + out.stderr
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
