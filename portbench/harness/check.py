"""Whether the timed path trained right: its first steps against the reference.

The trainer's first three steps run in set-up through the window's own
call and feed.  Once the window has closed and the program's state is
freed, the plain float32 reference (``portbench/refs``) trains from the
same initial weights on the same windows, which it builds itself from
the episodes as generated, and the numbers below compare the two:

  forward_gap  the first step's forward, per element: the policy logits
               and the values the net returned on every observed step
               past the burn-in, both heads' together, as the root of
               the summed squared gap over the root of the reference's
               summed squares (an output missing reads inf); each
               head's own beside it (``forward_gap_policy``,
               ``forward_gap_value``: a net's one value unit can cancel
               to near nought on a seed, so its own gap swings);
  loss_gap     the worst of the three steps' total loss, as the gap
               ``|program - reference|`` over the reference's scale
               ``|policy| + |value| + entropy_regularization * |entropy|``;
  count_gap    the acting steps each step trained on (the loss's data
               count), program against reference: exact, limit 0;
  delta_flips  the share of parameters whose change over the three steps
               points the other way than the reference's;
  delta_gap    each parameter's change over the three steps, by the worst
               leaf: the gap of the two norms over the larger of the
               reference leaf's norm and the median leaf's, leaving out
               the leaves whose reference gradient is under a thousandth
               of the median leaf's (round-off moves them under Adam);
  bad_draws    the drawn windows that name no filled slot, start past an
               episode's last full window or sit no seat, and repeated
               steps' draws; limit 0.

Each cell's ``limits/<cell>.json`` names the numbers that decide
``correct`` and why (PERF.md gives the readings they were set from).
"""

import math
import statistics

import numpy as np
import torch

from ..refs import train as ref_train

TINY_GRAD = 1e-3


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def worst_leaf(prog, ref, keep):
    """max over the leaves ``keep`` of ``|prog - ref| / max(ref, median
    ref)``."""
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keep)


def host_draws(draws):
    return [tuple(t.cpu().numpy() for t in d) for d in draws]


def bad_draws(draws, sources, episode_of, forward_steps, players):
    bad = 0
    for slots, tstarts, seats in draws:
        for s, t, q in zip(slots, tstarts, seats):
            if not 0 <= s < len(episode_of):
                bad += 1
                continue
            T = len(sources[episode_of[int(s)]]["present"])
            if not (0 <= t < max(1, T - forward_steps + 1)
                    and 0 <= q < players):
                bad += 1
    for a, b in zip(draws, draws[1:]):
        bad += all(np.array_equal(x, y) for x, y in zip(a, b))
    return bad


def reference_steps(cell, init, sources, episode_of, draws, device,
                    precision="float32", half=False):
    """The reference's three steps on the program's draws: each step's
    loss sums, the first step's gradient norms by leaf and raw outputs,
    the parameters after the third.  ``half`` plants the half-batch
    fault: only the first half of the windows, the loss doubled (the
    mean over the rest)."""
    args = cell.train_args
    burn, fwd = args.get("burn_in_steps", 0), args["forward_steps"]
    obs_elems = int(np.prod(sources[0]["obs"].shape[2:]))
    block = max(1, 2 ** 26 // ((burn + fwd) * obs_elems))
    with ref_train.exact_float32():
        ref = ref_train.Reference(cell.config["name"],
                                  cell.config["net"]["config"], args, init,
                                  device, precision=precision, block=block)
        sums, raw1, out1 = [], None, None
        for slots, tstarts, seats in draws:
            B = len(slots)
            rows = np.arange(B // 2 if half else B)

            def make_block(r, slots=slots, tstarts=tstarts, seats=seats):
                return ref_train.windows(sources, episode_of, slots[r],
                                         tstarts[r], seats[r], burn, fwd,
                                         device)

            s, raw, out = ref.step(make_block, rows,
                                   weight=2.0 if half else 1.0)
            sums.append(s)
            if raw1 is None:
                raw1, out1 = _norms(raw), out
    return {"losses": sums, "raw": raw1, "outputs": out1,
            "params": {k: v.detach() for k, v in ref.params.items()}}


def forward_gap(prog, ref):
    """``forward_gap`` and each head's, ``{"": both, "policy": ...,
    "value": ...}``, of the outputs ``prog`` (``policy`` ``(B, T, A)``,
    ``value`` ``(B, T)``) against the reference's ``ref`` (with its
    ``mask``)."""
    mask = ref["mask"].bool()
    sq = {}
    for k in ("policy", "value"):
        p = prog.get(k) if prog else None
        if p is None or p.shape != ref[k].shape:
            return {"": math.inf, "policy": math.inf, "value": math.inf}
        r = ref[k].double()
        sq[k] = (float(((p.to(r.device).double() - r)[mask] ** 2).sum()),
                 float((r[mask] ** 2).sum()))
    out = {k: math.sqrt(g / max(n, 1e-300)) for k, (g, n) in sq.items()}
    out[""] = math.sqrt(sum(g for g, _ in sq.values())
                        / max(sum(n for _, n in sq.values()), 1e-300))
    return out


def compare(cell, prog, ref, init):
    """The numbers of ``prog`` (``losses``: its steps' loss dicts,
    ``outputs``: its first step's raw outputs, ``params``: after step
    3; the program's, or a control's or a
    planted fault's :func:`reference_steps`) against the reference's."""
    reg = cell.train_args["entropy_regularization"]
    loss_gap = 0.0
    for p, r in zip(prog["losses"], ref["losses"]):
        scale = abs(r["p"]) + abs(r["v"]) + reg * abs(r["ent"])
        loss_gap = max(loss_gap, abs(p["total"] - r["total"]) / scale)
    moved = {k: v.to(init[k].device) - init[k]
             for k, v in prog["params"].items()}
    moved_ref = {k: ref["params"][k].to(init[k].device) - init[k]
                 for k in moved}
    flips = sum(int((moved[k] * moved_ref[k] < 0).sum()) for k in moved)
    med = statistics.median(ref["raw"].values())
    keep = [k for k, n in ref["raw"].items() if n >= TINY_GRAD * med]
    fwd = forward_gap(prog["outputs"], ref["outputs"])
    return {
        "forward_gap": fwd[""],
        "forward_gap_policy": fwd["policy"],
        "forward_gap_value": fwd["value"],
        "loss_gap": loss_gap,
        "count_gap": max(abs(p["dcnt"] - r["dcnt"])
                         for p, r in zip(prog["losses"], ref["losses"])),
        "delta_flips": flips / sum(v.numel() for v in moved.values()),
        "delta_gap": worst_leaf(_norms(moved), _norms(moved_ref), keep)}


def judge(readings, limits):
    """``(correct, {name: {"value", "limit"}})`` over the numbers the
    cell's limits name."""
    out = {k: {"value": readings[k], "limit": lim["limit"]}
           for k, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
