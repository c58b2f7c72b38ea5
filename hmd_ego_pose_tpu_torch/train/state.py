"""The optimizer of training: Adam (``torch.optim``), or SGD with Nesterov momentum.

Counterpart of ``hmd_ego_pose_tpu/train/state.py`` (optax):

* Adam(lr, b1 0.9, b2 0.999, eps 1e-8, each rounded to float32 as optax
  holds them) for training, ``NesterovSGD`` (lr, momentum 0.9) for
  ``fine_tune``: the same update formulas as optax's ``adam`` and
  ``sgd(nesterov=True)`` (Adam rounded differently: agreement is a float32
  tolerance, not bits; ``NesterovSGD`` rounds as optax run op by op);
* ``freeze_backbone``: optax's ``multi_transform`` with ``set_to_zero``
  keeps the backbone bit-identical and keeps no moments for it; here the
  backbone's parameters are not given to ``torch.optim`` at all and take no
  gradient.  Its BNs still move their running statistics (the model is in
  training mode), as in JAX;
* ``clip_grad_norm`` > 0: optax's ``clip_by_global_norm`` over the trainable
  gradients: unchanged while the global norm is below the limit, else each
  gradient becomes ``(g / norm) * limit``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6, so it is not used);
* the learning rate is injected: ``set_learning_rate`` writes it into the
  parameter groups.  On a CUDA card both optimizers are ``capturable``: the
  learning rate is a float32 device tensor (optax's injected float32), which
  ``set_learning_rate`` fills in place; Adam runs ``torch.optim.Adam(capturable=True)``
  and SGD ``NesterovSGD``, whose update is ``torch._foreach_*`` ops over that
  tensor.  Neither update has host arithmetic or a host read, so a CUDA graph
  of the train step holds it (``train/step.py``), and the plateau schedule
  changes the rate without a new capture.  The eager steps on the card use
  the same optimizer, so graph and eager make the same update.  On the CPU
  Adam keeps a float rate and SGD the same float32 tensor;
* under a data-parallel mesh (``parallel/mesh.py``) the gradients are
  averaged over the ranks before the clip, in one all-reduce of the
  trainable gradients packed into one buffer, so the clip's norm is the
  global one, as optax's is under GSPMD.  Not ``DistributedDataParallel``:
  the BN buffers already agree (its buffer broadcast is not wanted), and
  one explicit all-reduce after ``backward()`` needs no hooks.  It holds
  with frozen parameters (they are not in ``params`` on any rank), with
  drop-connect (a mask multiplies, it cuts no edge of the graph) and with
  ``torch.utils.checkpoint`` (the recompute has run when ``backward()``
  returns).  The graph depends on the config, not on the rows, so the same
  parameters have gradients on every rank and every rank packs the same
  layout.  In a single process (a mesh of one) the all-reduce is a no-op.
  Under a space axis the same all-reduce spans (data x space), the mean
  over its D * S ranks: each rank's gradient is a part of its data row's
  (``parallel/spatial.py``), so the parts are summed over space, and the
  rows averaged over data.

``leaves()`` and ``load_leaves()`` carry the state in the layout of the JAX
package's checkpoints, ``jax.tree.leaves`` of its optax state:

* Adam: the injected count, b1, b2, eps, eps_root, the learning rate, Adam's
  count, every first moment, then every second moment;
* SGD: the injected count, the learning rate, every momentum trace;

moments in the params' ``jax.tree.leaves`` order (without the backbone when
it is frozen), conv kernels in HWIO.  So either package resumes the other's
run.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.config import ModelConfig, TrainConfig
from hmd_ego_pose_tpu_torch.models.weights import jax_leaf_paths
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL, DataMesh

# optax's injected hyperparameters are float32 scalars, so it computes
# 1 - b2 in float32 (0.00099998713, 1.3e-5 below 0.001); torch takes the
# betas as Python floats, so it is given the float32-rounded values and
# computes the same factors
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = (float(np.float32(v)) for v in (0.9, 0.999, 1e-8, 0.0))


def _to_jax(t: torch.Tensor, kind: str) -> np.ndarray:
    """A copy, never a view of the optimizer's state (a CPU tensor's
    ``numpy()`` shares its memory)."""
    t = t.detach().float()
    if kind == "conv":
        t = t.permute(2, 3, 1, 0)
    return np.array(t.cpu().numpy(), order="C")


def _from_jax(a, kind: str, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a, np.float32))
    if kind == "conv":
        t = t.permute(3, 2, 0, 1)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"optimizer leaf of shape {tuple(t.shape)} for a parameter of shape {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype).contiguous()


class NesterovSGD(torch.optim.Optimizer):
    """optax's ``sgd(lr, momentum, nesterov=True)`` over a float32 learning-rate
    tensor (``param_groups[0]["lr"]``): per parameter, ``t = g + m * t`` and
    ``p -= lr * (g + m * t)``, each operation rounded on its own as optax's
    are (``p + (g + m * t) * -lr``: the negation is exact).  The momentum
    traces are ``state[p]["momentum_buffer"]``, zeros before the first step."""

    def __init__(self, params, lr: torch.Tensor, momentum: float):
        super().__init__(params, {"lr": lr, "momentum": momentum})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if "momentum_buffer" not in self.state[p]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(p)
            traces = [self.state[p]["momentum_buffer"] for p in params]
            m = group["momentum"]
            torch._foreach_mul_(traces, m)
            torch._foreach_add_(traces, grads)  # t = g + m t
            updates = torch._foreach_mul(traces, m)
            torch._foreach_add_(updates, grads)  # g + m t
            torch._foreach_mul_(updates, group["lr"])
            torch._foreach_sub_(params, updates)


class Optimizer:
    """Adam or ``NesterovSGD`` over the trainable parameters of an
    ``HMDEgoPose``, with optax's clip, freeze and injected learning rate."""

    def __init__(self, model: torch.nn.Module, config: TrainConfig, model_config: ModelConfig,
                 mesh: DataMesh = LOCAL):
        self.config, self.mesh = config, mesh
        self.entries = jax_leaf_paths(model_config, exclude_backbone=config.freeze_backbone)
        named = dict(model.named_parameters())
        self.params = [named[key] for key, _, _ in self.entries]
        if config.freeze_backbone:
            for key, p in named.items():
                if key.startswith("backbone_net."):
                    p.requires_grad_(False)
        lr = config.learning_rate
        device = self.params[0].device if self.params else torch.device("cpu")
        self.capturable = device.type == "cuda"
        if config.fine_tune:
            self.opt = NesterovSGD(self.params, torch.tensor(lr, dtype=torch.float32, device=device),
                                   config.sgd_momentum)
        elif self.capturable:
            self.opt = torch.optim.Adam(self.params, lr=torch.tensor(lr, dtype=torch.float32, device=device),
                                        betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS, capturable=True)
        else:
            self.opt = torch.optim.Adam(self.params, lr=lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)
        self.count = 0

    @property
    def learning_rate(self) -> float:
        return float(self.opt.param_groups[0]["lr"])

    def set_learning_rate(self, lr: float) -> None:
        for group in self.opt.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(float(lr))  # in place: a captured step reads this tensor
            else:
                group["lr"] = float(lr)

    def clip_gradients(self) -> None:
        """optax ``clip_by_global_norm``: g -> (g / norm) * limit when norm >= limit."""
        limit = self.config.clip_grad_norm
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale_all = norm >= limit
        for g in grads:
            g.copy_(torch.where(scale_all, (g / norm) * limit, g))

    def step(self) -> None:
        """One update from the gradients on the parameters; clears them after."""
        # every trainable gradient becomes its mean over the (data x space) ranks
        # (one all-reduce); every rank runs the same graph, so the same ones exist
        self.mesh.mean_([p.grad for p in self.params if p.grad is not None], "grads", "batch")
        if self.config.clip_grad_norm and self.config.clip_grad_norm > 0:
            self.clip_gradients()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    # -- the JAX checkpoint layout ----------------------------------------------
    def leaves(self) -> List[np.ndarray]:
        """The state as the JAX package's ``jax.tree.leaves(opt_state)``."""
        count = np.asarray(self.count, np.int32)
        lr = np.asarray(self.learning_rate, np.float32)
        if self.config.fine_tune:
            traces = [_to_jax(self._state(p, "momentum_buffer"), kind)
                      for p, (_, _, kind) in zip(self.params, self.entries)]
            return [count, lr, *traces]
        hyper = [np.asarray(v, np.float32) for v in (ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT)]
        mu = [_to_jax(self._state(p, "exp_avg"), kind) for p, (_, _, kind) in zip(self.params, self.entries)]
        nu = [_to_jax(self._state(p, "exp_avg_sq"), kind) for p, (_, _, kind) in zip(self.params, self.entries)]
        return [count, *hyper, lr, count.copy(), *mu, *nu]

    def num_leaves(self) -> int:
        return (2 if self.config.fine_tune else 7) + len(self.params) * (1 if self.config.fine_tune else 2)

    def load_leaves(self, leaves) -> None:
        """Resume the moments and the count from ``leaves`` (JAX layout); the
        learning rate stays this run's, as the JAX trainer re-injects it."""
        if len(leaves) != self.num_leaves():
            raise ValueError(
                f"optimizer state mismatch: checkpoint has {len(leaves)} leaves, this optimizer "
                f"has {self.num_leaves()} (config fine_tune/freeze_backbone changed?)")
        n = len(self.params)
        self.count = int(np.asarray(leaves[0]))
        if self.config.fine_tune:
            for p, (_, _, kind), trace in zip(self.params, self.entries, leaves[2:]):
                self.opt.state[p] = {"momentum_buffer": _from_jax(trace, kind, p)}
            return
        step = int(np.asarray(leaves[6]))
        mu, nu = leaves[7:7 + n], leaves[7 + n:]
        for p, (_, _, kind), m, v in zip(self.params, self.entries, mu, nu):
            # a capturable Adam keeps its count on the parameters' device
            where = p.device if self.capturable else torch.device("cpu")
            self.opt.state[p] = {"step": torch.tensor(float(step), dtype=torch.float32, device=where),
                                 "exp_avg": _from_jax(m, kind, p), "exp_avg_sq": _from_jax(v, kind, p)}

    def _state(self, p: torch.Tensor, name: str) -> torch.Tensor:
        """A moment of ``p``, zeros before the first step (as optax initialises it)."""
        value = self.opt.state.get(p, {}).get(name)
        return torch.zeros_like(p) if value is None else value
