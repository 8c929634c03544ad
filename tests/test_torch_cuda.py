"""The port on the card: tests that need a CUDA device.

They skip where ``torch.cuda.is_available()`` is False, deciding inside
a fixture (never at import, so every xdist worker collects the same
tests).  This file imports nothing of JAX, so it also runs where only
the port is installed; on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance card vs CPU: cuDNN runs float32 convolutions in TF32 by
default (a 10-bit mantissa, about three decimal digits), so outputs
agree within 2e-3 times the largest output magnitude; same card, same
shapes agree within 1e-5.
"""

import time

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.convert import random_flax_params
from handyrl_tpu_torch.models.geese_net import GeeseNet
from handyrl_tpu_torch.pipeline import (
    InferenceService,
    PipelineClient,
    PipelineConfig,
    build_obs_spec,
)
from torchfix import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is "
                    "False here")
    return "cuda"


def _models(device, seed=0):
    params = random_flax_params(GeeseNet(), seed=seed)
    return (TorchModel.from_flax(GeeseNet(), params, device=device),
            TorchModel.from_flax(GeeseNet(), params, device="cpu"))


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    env = make_env({"env": "HungryGeese"})
    obs = []
    while len(obs) < n:
        env.reset()
        for _ in range(int(rng.integers(0, 8))):
            env.step({p: int(rng.integers(4)) for p in env.turns()})
            if env.terminal():
                break
        obs.extend(env.observation(p) for p in env.players())
    return np.stack(obs[:n])


def test_card_forward_matches_cpu(cuda_device):
    card, cpu = _models(cuda_device)
    batch = _batch(64)
    ref = cpu.inference_batch(batch)
    out = card.inference_batch(batch)
    scale = max(1.0, max(float(np.abs(v).max()) for v in ref.values()))
    for key in ("policy", "value"):
        assert out[key].dtype == np.float32
        np.testing.assert_allclose(out[key], ref[key], rtol=0,
                                   atol=2e-3 * scale)


def test_card_service_answers_like_the_local_forward(cuda_device):
    card, _ = _models(cuda_device, seed=1)
    env = make_env({"env": "HungryGeese"})
    cfg = PipelineConfig.from_config({"batch_window": 0.0,
                                      "fallback": "none"})
    svc = InferenceService(card, cfg, epoch=1, device=cuda_device)
    svc.start()
    client = PipelineClient(svc.attach(build_obs_spec(env, 64)), cfg)
    try:
        deadline = time.monotonic() + 60
        while svc.warm_pending or not client.healthy():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        batch = _batch(64, seed=2)
        served = client.wrap(card, 1).inference_batch(batch)
        local = card.inference_batch(batch)
        for key in ("policy", "value"):
            np.testing.assert_allclose(served[key], local[key], rtol=0,
                                       atol=1e-5)
        assert client.fallbacks == 0 and client.local_rows == 0
        assert svc.failure is None
    finally:
        svc.close()
        client.close()
