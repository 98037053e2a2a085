"""The LDM codec family (`sgdm_tpu_torch/models/codec.py`) against the JAX
package's modules, float32 on the CPU, at narrow widths: every leaf of the
flax params perturbed (`perturbed_flat`), bridged by `models/convert.py
codec_from_flax`, the same NHWC input.  Requirement: within 1e-5 of the
larger of 1 and the output's largest value.  Each class, the three
attention types, the asymmetric pad-then-stride-2 downsample (odd and even
sizes), GroupNorm's 32 groups and its C-group fallback, `resize` in each
mode up and down, and `FirstStagePostProcessor` with an ``encode_fn``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import codec as jc
from sgdm_tpu_torch.models import codec as tc
from sgdm_tpu_torch.models.convert import codec_from_flax

from torch_port_common import perturbed_flat, unflatten, one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
LDM = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,), resolution=8)

# name -> (JAX module, port module, input shape, extra call args)
CASES = {
    "ldm_vanilla": (lambda: jc.LDMModel(out_ch=3, **LDM), lambda: tc.LDMModel(out_ch=3, **LDM),
                    (2, 8, 8, 3), "t"),
    "ldm_linear_context": (lambda: jc.LDMModel(out_ch=3, use_linear_attn=True, **LDM),
                           lambda: tc.LDMModel(out_ch=3, use_linear_attn=True, in_channels=5,
                                               **LDM), (2, 8, 8, 3), "t_context"),
    "ldm_no_time_none": (lambda: jc.LDMModel(use_timestep=False, attn_type="none", **LDM),
                         lambda: tc.LDMModel(use_timestep=False, attn_type="none", **LDM),
                         (1, 8, 8, 3), None),
    "encoder": (lambda: jc.Encoder(z_channels=4, **LDM), lambda: tc.Encoder(z_channels=4, **LDM),
                (2, 8, 8, 3), None),
    "encoder_linear_single_z": (
        lambda: jc.Encoder(z_channels=3, double_z=False, use_linear_attn=True, **LDM),
        lambda: tc.Encoder(z_channels=3, double_z=False, use_linear_attn=True, **LDM),
        (1, 8, 8, 3), None),
    "encoder_32_groups": (
        lambda: jc.Encoder(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=8),
        lambda: tc.Encoder(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=8),
        (1, 8, 8, 3), None),
    "encoder_odd_size": (lambda: jc.Encoder(z_channels=2, ch=8, ch_mult=(1, 1, 2),
                                            num_res_blocks=1, resolution=9),
                         lambda: tc.Encoder(z_channels=2, ch=8, ch_mult=(1, 1, 2),
                                            num_res_blocks=1, resolution=9),
                         (1, 9, 9, 3), None),
    "decoder": (lambda: jc.Decoder(**LDM), lambda: tc.Decoder(z_channels=4, **LDM),
                (2, 4, 4, 4), None),
    "decoder_tanh": (lambda: jc.Decoder(tanh_out=True, **LDM),
                     lambda: tc.Decoder(z_channels=4, tanh_out=True, **LDM), (1, 4, 4, 4), None),
    "decoder_pre_end": (lambda: jc.Decoder(give_pre_end=True, **LDM),
                        lambda: tc.Decoder(z_channels=4, give_pre_end=True, **LDM),
                        (1, 4, 4, 4), None),
    "simple_decoder": (lambda: jc.SimpleDecoder(out_channels=3),
                       lambda: tc.SimpleDecoder(in_channels=4, out_channels=3), (2, 4, 4, 4), None),
    "upsample_decoder": (lambda: jc.UpsampleDecoder(ch=8, num_res_blocks=1),
                         lambda: tc.UpsampleDecoder(in_channels=4, ch=8, num_res_blocks=1),
                         (1, 4, 4, 4), None),
    "latent_rescaler_2": (lambda: jc.LatentRescaler(factor=2.0, mid_channels=8, out_channels=3),
                          lambda: tc.LatentRescaler(2.0, 4, 8, 3), (1, 4, 4, 4), None),
    "latent_rescaler_1_5": (lambda: jc.LatentRescaler(factor=1.5, mid_channels=8,
                                                      out_channels=3, depth=1),
                            lambda: tc.LatentRescaler(1.5, 4, 8, 3, depth=1), (1, 4, 4, 4), None),
    "merged_encoder": (lambda: jc.MergedRescaleEncoder(ch=8, ch_mult=(1, 2), num_res_blocks=1,
                                                       resolution=8, rescale_factor=0.5),
                       lambda: tc.MergedRescaleEncoder(ch=8, ch_mult=(1, 2), num_res_blocks=1,
                                                       resolution=8, rescale_factor=0.5),
                       (1, 8, 8, 3), None),
    "merged_decoder": (lambda: jc.MergedRescaleDecoder(z_channels=4, ch=8, ch_mult=(1, 2),
                                                       num_res_blocks=1, resolution=8),
                       lambda: tc.MergedRescaleDecoder(z_channels=4, ch=8, ch_mult=(1, 2),
                                                       num_res_blocks=1, resolution=8),
                       (1, 4, 4, 4), None),
    "upsampler": (lambda: jc.Upsampler(in_size=4, out_size=8, in_channels=4, out_channels=3),
                  lambda: tc.Upsampler(4, 8, 4, 3), (1, 4, 4, 4), None),
    "resnet_block_shortcut": (lambda: jc.CodecResnetBlock(out_channels=12, conv_shortcut=True,
                                                          temb_channels=6),
                              lambda: tc.CodecResnetBlock(8, 12, conv_shortcut=True,
                                                          temb_channels=6),
                              (2, 4, 4, 8), "temb"),
    "resnet_block_nin": (lambda: jc.CodecResnetBlock(out_channels=12, temb_channels=0),
                         lambda: tc.CodecResnetBlock(8, 12, temb_channels=0), (2, 4, 4, 8), None),
    "attn_block": (lambda: jc.AttnBlock(), lambda: tc.AttnBlock(8), (2, 4, 4, 8), None),
    "lin_attn_block": (lambda: jc.LinAttnBlock(), lambda: tc.LinAttnBlock(8), (2, 4, 4, 8), None),
    "post_processor": (lambda: jc.FirstStagePostProcessor(ch_mult=(1, 2), n_channels=8,
                                                          reshape=True),
                       lambda: tc.FirstStagePostProcessor((1, 2), 6, 8, reshape=True),
                       (2, 8, 8, 6), "encode"),
}


def _args(kind, b, rng):
    if kind == "t":
        return {"t": rng.integers(0, 1000, b).astype(np.int32)}
    if kind == "t_context":
        return {"t": rng.integers(0, 1000, b).astype(np.int32),
                "context": rng.normal(size=(b, 8, 8, 2)).astype(np.float32)}
    if kind == "temb":
        return {"temb": rng.normal(size=(b, 6)).astype(np.float32)}
    return {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_codec_module_matches_jax(case):
    make_j, make_t, shape, kind = CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=shape).astype(np.float32)
    kw = _args(kind, shape[0], rng)
    jm, tm = make_j(), make_t()
    scale = np.float32(0.5)
    enc_j = (lambda z: z * scale) if kind == "encode" else None
    enc_t = (lambda z: z * scale) if kind == "encode" else None
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    init = partial(jm.init, encode_fn=enc_j) if enc_j else jm.init
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), jnp.asarray(x), **jkw)["params"]
    if enc_j:
        jkw["encode_fn"] = enc_j
    flat = perturbed_flat(shapes, seed=3)
    tm.load_state_dict(codec_from_flax(flat, tm))
    want = np.asarray(jm.apply({"params": unflatten(flat)}, jnp.asarray(x), **jkw))
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    if enc_t:
        tkw["encode_fn"] = enc_t
    with torch.no_grad():
        got = tm(torch.from_numpy(x), **tkw).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max()), \
        np.abs(got - want).max()


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("factor", [2.0, 0.5, 1.5, 1.0])
def test_resize_matches_jax(mode, factor):
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jc.resize(jnp.asarray(x), factor, mode))
    got = tc.resize(torch.from_numpy(x), factor, mode).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_downsample_pads_after_then_strides():
    """The pad (0, 1, 0, 1): an impulse at the last row and column reaches
    the last output only; a symmetric pad would move it."""
    ds = tc.Downsample(1)
    with torch.no_grad():
        ds.conv.weight.zero_()
        ds.conv.weight[0, 0, 0, 0] = 1.0
        ds.conv.bias.zero_()
    x = torch.zeros(1, 1, 8, 8)
    x[0, 0, 6, 6] = 1.0
    y = ds(x)
    assert y.shape == (1, 1, 4, 4) and y[0, 0, 3, 3] == 1.0 and y.sum() == 1.0
