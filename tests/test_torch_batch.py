"""The port's ``make_batch`` against the JAX package's.

Both packages assemble a batch from the same episode windows; every
tensor must be equal, bit for bit.  bfloat16 observations: the JAX
package emits ``ml_dtypes.bfloat16``, the port its ``uint16`` bit
pattern, and the two bit patterns must be the same.
"""

import numpy as np
import pytest

from handyrl_tpu import batch as jbatch
from handyrl_tpu_torch import batch as tbatch
from torchfix import draws, make_episodes, one_torch_thread, window  # noqa: F401

MODES = {
    # name: (env, turn_based_training, observation)
    "turn": ("TicTacToe", True, False),
    "all": ("TicTacToe", True, True),
    "seat": ("HungryGeese", False, False),
}


def _cfg(mode, transfer=None, burn_in=0):
    _env, turn_based, observation = MODES[mode]
    cfg = {"turn_based_training": turn_based, "observation": observation,
           "forward_steps": 8, "burn_in_steps": burn_in,
           "compress_steps": 4}
    if transfer:
        cfg["transfer_dtype"] = transfer
    return cfg


def _batches(mode, cfg, monkeypatch, n=12, seed=0):
    episodes, players = make_episodes(
        MODES[mode][0], 6 if mode != "seat" else 3, seed=seed,
        observation=cfg["observation"])
    picks = draws(episodes, cfg, n, len(players), seed)
    sels = [window(episodes[i], t, cfg) for i, t, _ in picks]
    seats = [players[s] for _, _, s in picks]
    out = []
    for module in (jbatch, tbatch):
        it = iter(seats)
        monkeypatch.setattr(module.random, "choice", lambda seq: next(it))
        out.append(module.make_batch(sels, cfg))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("transfer", [None, "bfloat16", "uint8"])
def test_make_batch_equals_jax(mode, transfer, monkeypatch):
    cfg = _cfg(mode, transfer)
    jb, tb = _batches(mode, cfg, monkeypatch)
    assert sorted(jb) == sorted(tb)
    for key in jb:
        j, t = np.asarray(jb[key]), np.asarray(tb[key])
        if key == "observation" and transfer == "bfloat16":
            assert t.dtype == np.uint16
            j = j.view(np.uint16)
        assert j.dtype == t.dtype, key
        assert j.shape == t.shape, key
        np.testing.assert_array_equal(t, j, err_msg=key)


def test_burn_in_padding_equals_jax(monkeypatch):
    cfg = _cfg("turn", burn_in=3)
    jb, tb = _batches("turn", cfg, monkeypatch, seed=4)
    for key in jb:
        np.testing.assert_array_equal(np.asarray(tb[key]),
                                      np.asarray(jb[key]), err_msg=key)


def test_bf16_bits_round_to_nearest_even():
    import ml_dtypes

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32),
                        np.float32([0, -0.0, 1, 1.00390625, 1.01171875,
                                    3.0e38, -7.5e-39])])
    ref = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tbatch.to_bf16_bits(x), ref)


def test_decompress_moments_equals_jax():
    episodes, _ = make_episodes("TicTacToe", 2, seed=9)
    cfg = {"forward_steps": 4, "burn_in_steps": 1, "compress_steps": 4}
    sel = window(episodes[1], 3, cfg)
    got = tbatch.decompress_moments(sel)
    assert len(got) == sel["end"] - sel["start"]
    assert repr(got) == repr(jbatch.decompress_moments(sel))


def test_uint8_wire_refuses_fractional_observations():
    with pytest.raises(ValueError, match="integer-valued"):
        tbatch._encode_obs(np.float32([[0.5]]), "uint8")
