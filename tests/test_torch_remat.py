"""``TrainingConfig.remat`` in the port against a plain train step and
against the JAX package's ``remat=True`` step, on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

from custom_yolo_tpu.config import TrainingConfig as JaxTrainingConfig
from custom_yolo_tpu.core.dtypes import resolve_policy as jax_policy
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu.train import optim as jax_optim
from custom_yolo_tpu.train.losses import (DetectionLoss as JaxDetectionLoss,
                                          LossConfig as JaxLossConfig)
from custom_yolo_tpu.train.train_step import (
    make_train_step as jax_make_train_step)
from custom_yolo_tpu_torch.config import TrainingConfig
from custom_yolo_tpu_torch.models.detector import create_train_model
from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
from custom_yolo_tpu_torch.train.optim import build_optimizer
from custom_yolo_tpu_torch.train.train_step import make_train_step
from custom_yolo_tpu_torch.utils.weights import train_state_from_jax
from test_torch_train import (EMA_DECAY, EMA_TAU, HW, LR, NC, WARMUP,
                              _assert_metrics_match, _assert_state_matches,
                              _batches, _jax_state_as_numpy,
                              _mid_training_state, _torch_batch)
from torch_project import random_jax_variables

torch.set_num_threads(2)

WIDTH = (3, 8, 16, 32, 64, 64)
DEPTH = (1, 1, 1, 1, 1, 1)
CSP = (False, True)


def test_remat_step_equals_plain_and_tracks_jax():
    """``remat`` recomputes the backbone and the neck in the backward pass
    and leaves the BatchNorm statistics to the forward. One fp32 step from
    a carried mid-training state (warm-up, EMA and clipping on): against
    the plain step, loss and gradients within 1e-6 and the running
    statistics bit for bit; against JAX's step with ``remat=True``, the
    whole-step limits of tests/test_torch_train.py."""
    model_j = JaxYoloModel(WIDTH, DEPTH, CSP, NC,
                           policy=jax_policy("float32"), remat=True)
    variables = random_jax_variables(model_j, HW, seed=1)
    tx = jax_optim.build_optimizer(JaxTrainingConfig(learning_rate=LR,
                                                     grad_clip=1.0))
    step_j = jax_make_train_step(
        model_j, JaxDetectionLoss(JaxLossConfig(num_classes=NC)), tx,
        donate=False, ema_decay=EMA_DECAY, ema_tau=EMA_TAU,
        warmup_steps=WARMUP)
    mid = _mid_training_state(variables, tx)
    start = _jax_state_as_numpy(mid)
    batch = _batches()[0]
    state_j, metrics_j = step_j(mid, {k: jnp.asarray(v)
                                      for k, v in batch.items()})

    runs = {}
    for remat in (False, True):
        model = create_train_model(WIDTH, DEPTH, CSP, NC,
                                   precision="float32", device="cpu",
                                   remat=remat)
        optimizer = build_optimizer(model.parameters(), TrainingConfig(
            learning_rate=LR, grad_clip=1.0))
        state = train_state_from_jax(start, model, optimizer)
        step = make_train_step(model, DetectionLoss(LossConfig(
            num_classes=NC)), optimizer, ema_decay=EMA_DECAY,
            ema_tau=EMA_TAU, warmup_steps=WARMUP)
        state, metrics = step(state, _torch_batch(batch))
        runs[remat] = (metrics, {k: p.grad.clone()
                                 for k, p in model.named_parameters()},
                       state)
    (m0, g0, state0), (m1, g1, state1) = runs[False], runs[True]
    np.testing.assert_allclose(float(m1["total_loss"]),
                               float(m0["total_loss"]), atol=1e-6, rtol=0)
    for key, grad in g0.items():
        np.testing.assert_allclose(g1[key].numpy(), grad.numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)
    stats = [k for k in state0.variables if "running_" in k]
    assert stats
    for key in stats:
        assert torch.equal(state1.variables[key], state0.variables[key]), key
    _assert_metrics_match(m1, {k: float(v) for k, v in metrics_j.items()},
                          "remat step")
    _assert_state_matches(state1, _jax_state_as_numpy(state_j))
