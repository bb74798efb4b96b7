"""SGD learner: optimizer, learning-rate schedule, train step (counterpart
of ``nuzero_tpu/training/learner.py``; behavioral target the reference's
``Training/AlphaZero.py:836-955`` and ``general_utils.py:24-34``).

Parameters are explicit, as in the JAX package: ``TrainState.params`` is a
``state_dict``-style mapping of f32 tensors, applied to the manager's module
with ``torch.func.functional_call``.  One update differentiates the loss
with ``torch.autograd.grad`` (the hex convs' backward runs on the CUDA
kernels on the card) and applies optax's update rules written out:

- Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), bias-corrected by its own
  update count;
- SGD: ``add_decayed_weights(weight_decay)``, then momentum, Nesterov or
  not (``optax.sgd``);
- an unknown optimizer name falls back to Adam (ref ``general_utils.py:32-34``);
- the piecewise-constant schedule reads the count of applied updates
  before the update and scales from the update whose count equals a
  boundary (optax's ``sign(boundary - count)``).  ``set_schedule_count``
  overwrites that count.

A network with BatchNorm (``networks/blocks.py``) trains as torch's
``nn.BatchNorm2d`` does, the upstream rule (the JAX learner cannot train
one: Flax refuses its ``batch_stats`` update): the update's forward
normalizes by the batch's statistics, and after the optimizer step the
running means and variances move by them (momentum 0.1), returned in the
new ``TrainState.params``.  The optimizer, its state, weight decay and the
gradient norm see the parameters alone, never those buffers.  A mesh
(cross-rank batch statistics) and ``train_step_multi`` (one forward per
game type would normalize each by its own statistics) refuse such a net.

The progressive loss draws n ~ U{0..m-1}, k ~ U{1..m-n} on the host from a
``torch.Generator`` (``progressive_draws``); tests substitute recorded draws.

Data parallel (``mesh``, ``parallel/mesh.py``): every rank is handed the
same global batch, whose rows must divide evenly over the ranks, and
forwards and backpropagates its own block of rows (the mesh's
``shard_batch`` placement), its loss scaled by 1 / world size, so that the
sum of the ranks' gradients is the global batch's mean gradient.  The gradients and the loss metrics go
through one all-reduce of one flat buffer in the parameters' order, so
every rank applies the same update and the parameters stay bit-equal
across ranks.  The progressive loss's (n, k) come from the host
generator, which every rank seeds alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from nuzero_tpu_torch.networks.blocks import batch_statistics, update_running_stats
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.parallel.mesh import shard_batch
from nuzero_tpu_torch.training import losses
from nuzero_tpu_torch.utils.profiling import span

Params = Dict[str, torch.Tensor]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: dict  # {"schedule_count": int, "count": int, "mu", "nu"} or {"schedule_count", "trace"}
    step: int  # number of applied updates


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    """Static learner hyperparameters (training-config YAML subset)."""

    policy_loss: str = "CEL"
    value_loss: str = "SE"
    normalize_policy: bool = False
    optimizer: str = "Adam"
    learning_rate: float = 5.0e-5
    scheduler_boundaries: Tuple[int, ...] = ()
    scheduler_gamma: float = 0.5
    weight_decay: float = 1.0e-7
    momentum: float = 0.9
    nesterov: bool = False
    train_iterations: int = 2  # recurrent nets only
    prog_alpha: float = 0.0  # progressive loss mix; 0 = disabled
    # Per-game-type recurrent iteration counts for multi-type updates
    # (``train_step_multi``).  Empty = ``train_iterations`` for every type.
    train_iterations_per_type: Tuple[int, ...] = ()


def progressive_draws(rng: torch.Generator, m: int) -> Tuple[int, int]:
    """(n, k) of the progressive loss: n ~ U{0..m-1}, k ~ U{1..m-n}
    (ref ``AlphaZero.py:941-946``), from a host generator."""
    n = int(torch.randint(0, m, (), generator=rng))
    k = int(torch.randint(1, m - n + 1, (), generator=rng))
    return n, k


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class Learner:
    def __init__(self, manager: NetworkManager, config: LearnerConfig,
                 draws: Callable[[torch.Generator, int], Tuple[int, int]] = progressive_draws,
                 mesh=None):
        """The learner runs where ``manager``'s module lies; ``mesh`` makes
        each update data-parallel over its ranks (see the module), for a net
        without BatchNorm."""
        if manager.has_batch_norm and mesh is not None:
            raise NotImplementedError(
                "Learner: a network with batch_norm on a mesh needs cross-rank batch "
                "statistics (synchronized BatchNorm), which the port does not implement")
        self.manager = manager
        # The module's buffers (BatchNorm's running statistics): carried
        # through the optimizer untouched, moved by ``update_running_stats``.
        self._buffers = frozenset(name for name, _ in manager.module.named_buffers())
        self._batch_norm = manager.has_batch_norm
        self.config = config
        self.draws = draws
        self.mesh = mesh
        self.adam = config.optimizer != "SGD"
        # optax's piecewise_constant_schedule: one scale per distinct boundary.
        self._boundaries = sorted({int(b) for b in config.scheduler_boundaries})

    def learning_rate(self, count: int) -> float:
        """The schedule's value (f32) at ``count`` applied updates."""
        lr = np.float32(self.config.learning_rate)
        for b in self._boundaries:
            if count >= b:
                lr = np.float32(lr * np.float32(self.config.scheduler_gamma))
        return float(lr)

    def init_opt_state(self, params: Params) -> dict:
        params = {k: v for k, v in params.items() if k not in self._buffers}
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        if self.adam:
            return {"schedule_count": 0, "count": 0, "mu": zeros,
                    "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
        return {"schedule_count": 0, "trace": zeros}

    @staticmethod
    def set_schedule_count(opt_state: dict, count: int) -> dict:
        """The optimizer state with its schedule position set to ``count``
        (the reference's ``keep_scheduler`` resume switch: 0 restarts the
        schedule, the restored update count resumes it)."""
        return {**opt_state, "schedule_count": int(count)}

    def init_state(self, generator: torch.Generator) -> TrainState:
        params = self.manager.init(generator)
        return TrainState(params=params, opt_state=self.init_opt_state(params), step=0)

    # -- loss -----------------------------------------------------------------

    def _forward_loss(self, params, obs, policy_target, value_target, rng,
                      train_iters=None):
        cfg = self.config
        mgr = self.manager

        def one_loss(p_logits, v_pred):
            return losses.combined_loss(
                p_logits, v_pred, policy_target, value_target,
                policy_loss=cfg.policy_loss, value_loss=cfg.value_loss,
                normalize_policy=cfg.normalize_policy,
            )

        if not mgr.is_recurrent:
            p, v, _ = mgr.apply(params, obs)
            v_l, p_l, c_l = one_loss(p, v)
            return c_l, (v_l, p_l)

        m = cfg.train_iterations if train_iters is None else train_iters
        alpha = cfg.prog_alpha
        v_l = p_l = c_l = 0.0
        if alpha != 1.0:
            (pf, vf), _ = functional_call(mgr.module, params, (obs, m))
            v_f, p_f, c_f = one_loss(pf, vf)
            v_l = v_l + (1 - alpha) * v_f
            p_l = p_l + (1 - alpha) * p_f
            c_l = c_l + (1 - alpha) * c_f
        if alpha != 0.0:
            n, k = self.draws(rng, m)
            detach_at = n if n > 0 else None  # n = 0: no detach (ref :948-952)
            (pp, vp), _ = functional_call(mgr.module, params, (obs, m, None, detach_at, n + k))
            v_p, p_p, c_p = one_loss(pp, vp)
            v_l = v_l + alpha * v_p
            p_l = p_l + alpha * p_p
            c_l = c_l + alpha * c_p
        return c_l, (v_l, p_l)

    def _grads(self, loss: torch.Tensor, params: Params) -> Params:
        """The gradient of ``loss`` by every leaf of ``params`` that
        requires one (the buffers do not)."""
        params = {k: p for k, p in params.items() if p.requires_grad}
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return {k: torch.zeros_like(p) if g is None else g
                for (k, p), g in zip(params.items(), got)}

    def value_and_grad(self, params: Params, batch, rng, train_iters=None):
        """(combined loss, (value loss, policy loss), grads) of one batch
        (obs, policy_target, value_target, game_type).  With a mesh,
        ``batch`` is the global batch (the same on every rank), each rank
        differentiates its block of rows, and the losses and grads returned
        are the global batch's, summed over the ranks."""
        if self.mesh is not None:
            batch = self._rank_rows(batch)
        obs, policy_target, value_target, _ = batch
        leaves = self._leaves(params)
        with span("nuzero.learner.forward"):
            c_l, (v_l, p_l) = self._forward_loss(
                leaves, obs, policy_target, value_target, rng, train_iters)
        with span("nuzero.learner.backward"):
            if self.mesh is None:
                return c_l, (v_l, p_l), self._grads(c_l, leaves)
            share = 1.0 / self.mesh.size
            grads = self._grads(c_l * share, leaves)
            (c_l, v_l, p_l), grads = self.all_reduce(
                (c_l * share, v_l * share, p_l * share), grads)
            return c_l, (v_l, p_l), grads

    # -- update ---------------------------------------------------------------

    @torch.no_grad()
    def apply_gradients(self, state: TrainState, grads: Params) -> TrainState:
        """One optimizer update (optax's arithmetic, new tensors)."""
        opt = state.opt_state
        lr = self.learning_rate(opt["schedule_count"])
        params = {}
        if self.adam:
            count = opt["count"] + 1
            bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** count)
            bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** count)
            mu, nu = {}, {}
            for k, p in state.params.items():
                if k in self._buffers:
                    params[k] = p
                    continue
                g = grads[k]
                mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * opt["mu"][k]
                nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * opt["nu"][k]
                update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
                params[k] = p + update * -lr
            new_opt = {"schedule_count": opt["schedule_count"] + 1, "count": count,
                       "mu": mu, "nu": nu}
        else:
            cfg = self.config
            trace = {}
            for k, p in state.params.items():
                if k in self._buffers:
                    params[k] = p
                    continue
                g = grads[k] + cfg.weight_decay * p
                trace[k] = g + cfg.momentum * opt["trace"][k]
                update = g + cfg.momentum * trace[k] if cfg.nesterov else trace[k]
                params[k] = p + update * -lr
            new_opt = {"schedule_count": opt["schedule_count"] + 1, "trace": trace}
        return TrainState(params=params, opt_state=new_opt, step=state.step + 1)

    def _leaves(self, params: Params) -> Params:
        """Fresh autograd leaves of ``params``; the buffers take no gradient."""
        return {k: v.detach().requires_grad_(k not in self._buffers)
                for k, v in params.items()}

    def _batch_statistics(self):
        """The forward's normalization: ``batch_statistics`` of the module for
        a net with BatchNorm (-> its record), else nothing (-> {})."""
        if not self._batch_norm:
            return contextlib.nullcontext({})
        return batch_statistics(self.manager.module)

    def _move_running_stats(self, new: TrainState, records) -> TrainState:
        """``new`` with the running statistics moved by the update's record."""
        if not records:
            return new
        with span("nuzero.learner.norm_stats"):
            with torch.no_grad():
                moved = update_running_stats(new.params, records)
            return dataclasses.replace(new, params={**new.params, **moved})

    # -- data parallel ----------------------------------------------------------

    def _rank_rows(self, batch):
        """This rank's block of a global batch's rows."""
        return tuple(map(shard_batch(self.mesh).place, batch))

    def all_reduce(self, scalars, grads: Params):
        """Sum ``scalars`` (loss tensors) and ``grads`` over the ranks in one
        all-reduce of one flat f32 buffer, in the parameters' order."""
        keys = list(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in keys]
                         + [torch.stack([s.detach().float() for s in scalars])])
        self.mesh.all_reduce(flat)
        out, at = {}, 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[at:at + n].view_as(grads[k])
            at += n
        return list(flat[at:].unbind()), out

    def train_step(self, state: TrainState, batch, rng: Optional[torch.Generator] = None):
        """One SGD update on ``batch`` = (obs, policy_target, value_target,
        game_type); ``rng`` feeds the progressive loss's draws.  With a
        mesh, ``batch`` is the global batch (the same on every rank)."""
        with span("nuzero.learner.update"):
            with self._batch_statistics() as records:
                c_l, (v_l, p_l), grads = self.value_and_grad(state.params, batch, rng)
            metrics = {
                "loss/value": v_l.detach(),
                "loss/policy": p_l.detach(),
                "loss/combined": c_l.detach(),
                "grad_norm": global_norm(grads.values()),
            }
            with span("nuzero.learner.optimizer"):
                new = self.apply_gradients(state, grads)
            return self._move_running_stats(new, records), metrics

    def train_step_multi(self, state: TrainState, batches, rng: Optional[torch.Generator] = None):
        """One SGD update over per-game-type sub-batches, each forwarded at
        its own recurrent iteration count; the losses are weighted by each
        type's positions, plus ``loss/type{t}`` per type.  With a mesh each
        sub-batch is global and each rank forwards its block of each.  A net
        with BatchNorm is refused: each type's forward would normalize by
        its own sub-batch's statistics, where the upstream normalizes the
        whole batch at once."""
        if self._batch_norm:
            raise NotImplementedError(
                "Learner.train_step_multi: a network with batch_norm would normalize each "
                "game type's sub-batch by its own statistics; train one game type")
        with span("nuzero.learner.update"):
            iters = self.config.train_iterations_per_type or tuple(
                self.config.train_iterations for _ in batches)
            leaves = self._leaves(state.params)
            tot_c = tot_v = tot_p = 0.0
            n = 0
            per_type = {}
            for t, batch in enumerate(batches):
                size = batch[0].shape[0]
                if self.mesh is not None:
                    batch = self._rank_rows(batch)
                obs, pt, vt, _ = batch
                with span("nuzero.learner.forward"):
                    c_l, (v_l, p_l) = self._forward_loss(leaves, obs, pt, vt, rng,
                                                         train_iters=iters[t])
                b = obs.shape[0]
                tot_c = tot_c + c_l * b
                tot_v = tot_v + v_l * b
                tot_p = tot_p + p_l * b
                n += size
                per_type[f"loss/type{t}"] = c_l.detach() * (b / size)
            c_l, v_l, p_l = tot_c / n, tot_v / n, tot_p / n
            with span("nuzero.learner.backward"):
                grads = self._grads(c_l, leaves)
                if self.mesh is not None:
                    keys = list(per_type)
                    reduced, grads = self.all_reduce((c_l, v_l, p_l, *per_type.values()), grads)
                    (c_l, v_l, p_l), per_type = reduced[:3], dict(zip(keys, reduced[3:]))
            metrics = {
                "loss/value": v_l.detach(),
                "loss/policy": p_l.detach(),
                "loss/combined": c_l.detach(),
                "grad_norm": global_norm(grads.values()),
                **per_type,
            }
            with span("nuzero.learner.optimizer"):
                return self.apply_gradients(state, grads), metrics
