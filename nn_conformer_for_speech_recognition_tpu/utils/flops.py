"""Analytic model-FLOPs accounting for MFU reporting.

Counts the matmul/conv FLOPs of one ConformerCTC forward pass from the
configs alone (a matmul (m,k)x(k,n) = 2·m·k·n FLOPs), and models a train
step as 3x forward — the standard "model FLOPs" convention (params+activation
grads each cost one forward-equivalent; rematerialisation recompute is
deliberately NOT credited, so MFU stays comparable across remat settings).

MFU = model FLOPs/step ÷ step time ÷ the device's dense bf16 peak
(`peak_flops`, keyed by ``device_kind``; a device not in the table is an
error, not a default).

The reference publishes no FLOPs or MFU anywhere (SURVEY.md §6); this is
part of the perf/observability layer this build adds.
"""

from __future__ import annotations

import math

from nn_conformer_for_speech_recognition_tpu.config import ModelConfig

# dense bf16 tensor-core peak by jax Device.device_kind
PEAK_BF16_FLOPS = {
    # H100 SXM: 989 TFLOP/s bf16 dense at the 700 W limit (NVIDIA H100 data sheet)
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device_kind: str) -> float:
    try:
        return PEAK_BF16_FLOPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no bf16 peak recorded for device {device_kind!r} "
            f"(known: {sorted(PEAK_BF16_FLOPS)})"
        ) from None


def conformer_forward_flops(
    mcfg: ModelConfig, vocab_size: int, batch: int, frames: int
) -> float:
    """Matmul FLOPs of one ConformerCTC forward: subsampling convs →
    per-frame projection → N conformer blocks → BiLSTM CTC head."""
    sub = mcfg.subsampling
    d = mcfg.encoder.d_model
    total = 0.0

    # subsampling convs, NHWC (models/subsampling.py): each output element
    # costs 2·k·k·c_in; spatial dims shrink by the strides
    t, f, c_in = frames, mcfg.n_mels, 1
    for ch, k, st, sf in zip(
        sub.channels, sub.kernel_sizes, sub.time_strides, sub.freq_strides
    ):
        t = math.ceil(t / st)
        f = math.ceil(f / sf)
        total += batch * t * f * ch * 2 * k * k * c_in
        c_in = ch
    # flatten (f·c) → d_model per frame
    total += 2 * batch * t * (f * c_in) * d
    t_enc = t

    # conformer blocks
    e = mcfg.encoder
    h, dh = e.num_heads, d // e.num_heads
    ffn = 2 * (2 * batch * t_enc * d * e.ffn_dim) * 2  # two FFNs, two mats each
    qkv = 2 * batch * t_enc * d * 3 * d
    scores = 2 * batch * h * t_enc * t_enc * dh
    att_v = 2 * batch * h * t_enc * t_enc * dh
    # Transformer-XL rel-pos: q·p against the whole (2T-1) table (≈ 2x the
    # score matmul, before the rel-shift) + pos_proj
    relpos = 2 * scores + 2 * (2 * t_enc - 1) * d * d
    out_proj = 2 * batch * t_enc * d * d
    conv_pw1 = 2 * batch * t_enc * d * (2 * e.conv_expansion * d)
    conv_dw = 2 * batch * t_enc * (e.conv_expansion * d) * e.conv_kernel_size
    conv_pw2 = 2 * batch * t_enc * (e.conv_expansion * d) * d
    block = ffn + qkv + scores + att_v + relpos + out_proj + conv_pw1 + conv_dw + conv_pw2
    total += e.num_blocks * block

    # decoder: projection → BiLSTM → vocab head (models/asr.py)
    dec = mcfg.decoder
    p, lh = dec.projection_dim, dec.lstm_hidden
    total += 2 * batch * t_enc * d * p
    total += 2 * (2 * batch * t_enc * (p + lh) * 4 * lh)  # 2 directions
    total += 2 * batch * t_enc * (2 * lh) * vocab_size
    return float(total)


def train_step_flops(
    mcfg: ModelConfig, vocab_size: int, batch: int, frames: int
) -> float:
    """Model FLOPs of one train step = 3x forward (fwd + param-grad +
    activation-grad matmuls)."""
    return 3.0 * conformer_forward_flops(mcfg, vocab_size, batch, frames)


def mfu(
    mcfg: ModelConfig,
    vocab_size: int,
    batch: int,
    frames: int,
    step_seconds: float,
    device_kind: str,
) -> float:
    return (train_step_flops(mcfg, vocab_size, batch, frames) / step_seconds
            / peak_flops(device_kind))
