"""Analytic work of one GeeseNet training step, from the shapes alone.

FLOPs: twice the multiply-adds of the convolutions and linear layers,
once forward and twice backward (input and weight gradients), except
the stem, whose input is data and needs no gradient.  Norms and
elementwise operations are not counted.

Bytes, the least a step must move: the gathered observations read once
from the ring (bfloat16); each parameter, its gradient and both Adam
moments read and written once (float32); and each activation that the
backward pass reads (every convolution's output and every block's
input, and the heads' inputs) written once and read once at the
compute dtype's 2 bytes.
"""

CELLS = 7 * 11
PLANES = 17
ACTIONS = 4


def forward_macs(net):
    """``(all layers, the stem)`` multiply-adds of one row."""
    f, blocks = net["filters"], net["blocks"]
    stem = CELLS * 9 * PLANES * f
    return (stem + blocks * CELLS * 9 * f * f + f * ACTIONS + 2 * f,
            stem)


def params(net):
    f, blocks = net["filters"], net["blocks"]
    return (9 * PLANES * f + blocks * 9 * f * f + (blocks + 1) * 2 * f
            + f * ACTIONS + 2 * f)


def step(net, batch_size, burn_in, forward_steps):
    rows = batch_size * (burn_in + forward_steps)
    trained = batch_size * forward_steps
    macs, stem = forward_macs(net)
    flops = 2 * (rows * macs + trained * (2 * macs - stem))
    f, blocks = net["filters"], net["blocks"]
    saved = CELLS * f * (1 + 2 * blocks) + 3 * f
    nbytes = (rows * CELLS * PLANES * 2 + 32 * params(net)
              + trained * saved * 2 * 2)
    return {"flops": float(flops), "bytes": float(nbytes)}
