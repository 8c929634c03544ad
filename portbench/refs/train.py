"""Plain float32 reference of HandyRL's training step, from the episodes.

What one learner update does, written from HandyRL's published method
(DeNA/HandyRL, ``handyrl/train.py`` and ``handyrl/losses.py``) for the
settings the benchmark's configurations use: simultaneous moves (one
seat per window), no observation mode, TD / UPGO targets, the standard
(not IMPACT) policy loss, and a recurrent net's burn-in.  It reads the
episodes as the generator drew them and the drawn windows, and touches
nothing that the ported program built.

A window ``(episode, start, seat)`` covers steps ``g = start - burn_in
... start + forward_steps - 1``; a step outside the episode is padding
(mask 0, behaviour probability 1, every action illegal, value 0 before
the episode and the seat's outcome after it), and progress is ``g / T``
(1 on padding).  The net runs over every step (a recurrent net carries
its state, zeroed where the seat did not observe, the burn-in without
gradient); the policy logits are masked by turn and the illegal actions,
the value by observation; the burn-in steps are then dropped.  With
importance ratios ``rho = pi / mu`` clipped at 1, the value target is
TD(lambda) (gamma 1, the outcome as the last target, lambda 1 where the
seat did not observe), the advantage TD's or UPGO's, plus the recorded
return when the net has no return head.  The loss is summed, not
averaged: ``-log pi(a) * rho * A`` over acting steps, half the squared
value error over observed steps, minus ``entropy_regularization`` times
the policy entropy weighted by ``1 - progress * (1 - decay)``.

The update: the gradient's global norm clipped to 4, an L2 term of
1e-5 added, then Adam (0.9, 0.999, epsilon 1e-8 outside the square
root) at ``lr = 3e-8 * batch_size * forward_steps``.
"""

import contextlib
import importlib
import math

import numpy as np
import torch
import torch.nn.functional as F

ILLEGAL = 1e32
CLIP_NORM = 4.0
WEIGHT_DECAY = 1e-5
BETAS = (0.9, 0.999)
EPS = 1e-8
BASE_LR = 3e-8


def net_module(config_name):
    return importlib.import_module(f"portbench.refs.{config_name}")


class Exact:
    """float32: what enters a convolution or linear layer, the
    gradient leaving it, and an elementwise value the program keeps in
    its compute dtype (a recurrent cell's gates and state), as they
    are."""

    def __call__(self, x):
        return x

    def out(self, y):
        return y

    def val(self, v):
        return v


def _scaled(x, dtype):
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _GradFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return _scaled(grad, torch.float8_e5m2)


def _forward_e4m3(x):
    return x + (_scaled(x.detach(), torch.float8_e4m3fn) - x).detach()


class Fp8(Exact):
    """Float8 in bfloat16's place: what a convolution or linear layer
    reads (inputs, weights) and what it returns, and the elementwise
    values the program keeps in bfloat16, rounded to e4m3, the gradient
    at a layer's output to e5m2, each at a per-tensor scale;
    accumulation and everything else in float32."""

    def __call__(self, x):
        return _forward_e4m3(x)

    def out(self, y):
        return _GradFp8.apply(_forward_e4m3(y))

    def val(self, v):
        return _forward_e4m3(v)


def _int8(x):
    scale = x.abs().amax().clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


class _GradInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return _int8(grad)


class Int8(Exact):
    """Int8 in bfloat16's place: what a convolution or linear layer
    reads and returns, the elementwise values the program keeps in
    bfloat16, and the gradient at a layer's output, rounded to 255
    symmetric levels at a per-tensor scale; accumulation and everything
    else in float32."""

    def __call__(self, x):
        return x + (_int8(x.detach()) - x).detach()

    def out(self, y):
        return _GradInt8.apply(self(y))

    def val(self, v):
        return self(v)


PRECISIONS = {"float32": Exact, "fp8": Fp8, "int8": Int8}


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the reference's convolutions and matmuls."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def windows(sources, episode_of, slots, tstarts, seats, burn_in,
            forward_steps, device):
    """The reference batch of the windows ``(slots, tstarts, seats)``
    (host int arrays); ``episode_of[slot]`` indexes ``sources``."""
    t_win = burn_in + forward_steps
    B = len(slots)
    src0 = sources[0]
    obs = np.zeros((B, t_win) + src0["obs"].shape[2:], np.uint8)
    cols = {k: np.zeros((B, t_win), np.float32) for k in (
        "prob", "action", "value", "reward", "return", "valid",
        "present", "progress")}
    outcome = np.zeros(B, np.float32)
    for b in range(B):
        e = sources[episode_of[int(slots[b])]]
        q = int(seats[b])
        T = len(e["present"])
        g = int(tstarts[b]) - burn_in + np.arange(t_win)
        valid = (g >= 0) & (g < T)
        gc = np.clip(g, 0, T - 1)
        present = e["present"][gc, q] & valid
        obs[b] = e["obs"][gc, q] * present.reshape(
            (t_win,) + (1,) * (obs.ndim - 2))
        cols["prob"][b] = np.where(present, e["prob"][gc, q], 1.0)
        cols["action"][b] = np.where(present, e["action"][gc, q], 0)
        value = np.where(present, e["value"][gc, q], 0.0)
        cols["value"][b] = np.where(g >= T, e["outcome"][q], value)
        cols["reward"][b] = np.where(valid, e["reward"][gc, q], 0.0)
        cols["return"][b] = np.where(valid, e["return"][gc, q], 0.0)
        cols["valid"][b] = valid
        cols["present"][b] = present
        cols["progress"][b] = np.where(valid, g / T, 1.0)
        outcome[b] = e["outcome"][q]
    batch = {k: torch.from_numpy(v).to(device) for k, v in cols.items()}
    batch["obs"] = torch.from_numpy(obs).to(device).float()
    batch["outcome"] = torch.from_numpy(outcome).to(device)
    return batch


def _td(values, last, lam, gamma, upgo=False):
    """TD(lambda) or UPGO targets over dim 1, the last target ``last``."""
    T = values.shape[1]
    out = [None] * T
    out[-1] = last
    for t in range(T - 2, -1, -1):
        v_next = values[:, t + 1]
        blend = (1 - lam[:, t + 1]) * v_next + lam[:, t + 1] * out[t + 1]
        out[t] = gamma * (torch.maximum(v_next, blend) if upgo else blend)
    return torch.stack(out, 1)


def block_loss(net, params, netcfg, batch, cfg, q):
    """Summed loss components of one block of windows, and the net's
    raw outputs on it: ``policy`` ``(B, T, A)`` and ``value`` ``(B, T)``
    before any mask, and ``mask`` ``(B, T)``, 1 where the loss reads
    them (an observed step past the burn-in)."""
    burn = cfg["burn_in_steps"]
    obs = batch["obs"]
    B, T = obs.shape[:2]
    omask = batch["present"]                      # (B, T)
    if net.RECURRENT:
        hidden = net.init_hidden(B, netcfg, obs.device)
        pols, vals = [], []
        for t in range(T):
            grad = contextlib.nullcontext() if t >= burn \
                else torch.no_grad()
            with grad:
                m = omask[:, t].view(B, 1, 1, 1)
                h_in = {k: v * m for k, v in hidden.items()}
                pol, val, new = net.forward(params, obs[:, t], h_in,
                                            netcfg, q)
                hidden = {k: hidden[k] * (1 - m) + new[k] * m
                          for k in hidden}
            pols.append(pol)
            vals.append(val)
        policy, value = torch.stack(pols, 1), torch.stack(vals, 1)
    else:
        pol, val, _ = net.forward(params, obs.reshape((B * T,)
                                  + obs.shape[2:]), None, netcfg, q)
        policy = pol.view(B, T, -1)
        value = val.view(B, T, 1)
    raw = {"policy": policy.detach(), "value": value[..., 0].detach(),
           "mask": omask * (torch.arange(T, device=obs.device) >= burn)}
    tmask = omask
    amask = (1.0 - omask)[..., None] * ILLEGAL
    policy = policy * tmask[..., None] - amask
    value = value[..., 0] * omask
    s = slice(burn, None)
    policy, value = policy[:, s], value[:, s]
    b = {k: v[:, s] for k, v in batch.items()
         if k not in ("obs", "outcome")}
    emask, omask, tmask = b["valid"], b["present"], b["present"]
    outcome = batch["outcome"][:, None]

    log_mu = torch.log(b["prob"].clamp(1e-16, 1.0)) * emask
    log_pi_all = F.log_softmax(policy, -1)
    log_pi = log_pi_all.gather(-1, b["action"].long()[..., None])[..., 0] \
        * emask
    rho = torch.exp((log_pi.detach() - log_mu).clamp(-20.0, 20.0))
    rho = rho.clamp(max=1.0)
    v_ng = value.detach() * emask + outcome * (1 - emask)
    lam = cfg["lambda"] + (1 - cfg["lambda"]) * (1 - omask)
    last = batch["outcome"]
    target = _td(v_ng, last, lam, 1.0)
    if cfg["policy_target"] == cfg["value_target"]:
        adv = target - v_ng
    else:
        adv = _td(v_ng, last, lam, 1.0,
                  upgo=cfg["policy_target"] == "UPGO") - v_ng
    adv = adv + b["return"]        # no return head: the recorded return
    p_loss = (-log_pi * rho * adv * tmask).sum()
    v_loss = (((value - target) ** 2) * omask).sum() / 2
    entropy = -(log_pi_all.exp() * log_pi_all.clamp(-1e32, 0.0)).sum(-1) \
        * tmask
    decay = 1 - b["progress"] * (1 - cfg["entropy_regularization_decay"])
    ent_loss = -cfg["entropy_regularization"] * (entropy * decay).sum()
    return {"p": p_loss, "v": v_loss, "ent": entropy.sum(),
            "total": p_loss + v_loss + ent_loss, "dcnt": tmask.sum()}, raw


class Reference:
    """The reference trainer: float32 parameters and Adam state, one
    :meth:`step` per drawn batch, computed in blocks of windows."""

    def __init__(self, config_name, netcfg, cfg, init, device,
                 precision="float32", block=128):
        self.net = net_module(config_name)
        self.netcfg, self.cfg = netcfg, cfg
        self.q = PRECISIONS[precision]()
        self.block = block
        self.device = device
        self.params = {k: v.detach().to(device, torch.float32).clone()
                       .requires_grad_() for k, v in init.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.lr = BASE_LR * cfg["batch_size"] * cfg["forward_steps"]

    def step(self, make_block, rows, weight=1.0):
        """One update on the windows ``rows`` (``make_block(rows)`` ->
        a :func:`windows` batch); each block's loss is scaled by
        ``weight``.  Returns the summed loss components, the gradient
        before the clip and the net's raw outputs (:func:`block_loss`'s,
        the blocks' joined)."""
        sums, outs = {}, []
        grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        for lo in range(0, len(rows), self.block):
            batch = make_block(rows[lo:lo + self.block])
            losses, raw = block_loss(self.net, self.params, self.netcfg,
                                     batch, self.cfg, self.q)
            outs.append(raw)
            losses = {k: v * weight for k, v in losses.items()}
            names = list(self.params)
            got = torch.autograd.grad(losses["total"],
                                      [self.params[k] for k in names],
                                      allow_unused=True)
            for k, g in zip(names, got):
                if g is not None:
                    grads[k] += g
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v.detach())
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values()))
        scale = CLIP_NORM / norm if norm >= CLIP_NORM else 1.0
        self.count += 1
        bc1 = 1 - BETAS[0] ** self.count
        bc2 = 1 - BETAS[1] ** self.count
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k] * scale + WEIGHT_DECAY * p
                self.m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                self.v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = self.v[k].sqrt() / math.sqrt(bc2) + EPS
                p.sub_(self.lr / bc1 * self.m[k] / denom)
        outputs = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        return sums, grads, outputs
