"""Analytic work of one GRFNet training step, from the shapes alone.

FLOPs: twice the multiply-adds of the convolutions and linear layers;
every row (burn-in included) runs forward, the trained rows run
backward too, twice the forward's work (input and weight gradients)
less the first stem convolution's input gradient (its input is data).
Norms, gate nonlinearities and elementwise operations are not counted.

Bytes, the least a step must move: the gathered observations read once
from the ring (uint8); each parameter, its gradient and both Adam
moments read and written once (float32); and each activation that the
backward pass reads on a trained row (both stem outputs, each DRC
repeat's gate input, gates and cell state, the heads' bottlenecks)
written once and read once at the compute dtype's 2 bytes.
"""

FIELD = 72 * 96
HALF = 36 * 48
CORE = 18 * 24
PLANES = 16
ACTIONS = 9


def forward_macs(net):
    """``(all layers, the first stem convolution)`` multiply-adds of
    one row."""
    f = net["filters"]
    stem1 = HALF * 9 * PLANES * f
    macs = stem1 + CORE * 9 * f * f
    macs += net["drc_repeats"] * net["drc_layers"] * CORE * 9 * 2 * f * 4 * f
    macs += 2 * CORE * f * 2 + CORE * 2 * (ACTIONS + 1)
    return macs, stem1


def params(net):
    f, layers = net["filters"], net["drc_layers"]
    return (9 * PLANES * f + 9 * f * f + 4 * f
            + layers * (9 * 2 * f * 4 * f + 4 * f)
            + 2 * (2 * f + 2) + CORE * 2 * (ACTIONS + 1))


def step(net, batch_size, burn_in, forward_steps):
    rows = batch_size * (burn_in + forward_steps)
    trained = batch_size * forward_steps
    macs, stem1 = forward_macs(net)
    flops = 2 * (rows * macs + trained * (2 * macs - stem1))
    f = net["filters"]
    saved = (HALF * f + CORE * f + net["drc_repeats"] * net["drc_layers"]
             * CORE * 8 * f + 2 * CORE * 2)
    nbytes = rows * FIELD * PLANES + 32 * params(net) + trained * saved * 4
    return {"flops": float(flops), "bytes": float(nbytes)}
