"""The paper's Table-1 workloads as DNNGs — the port's own copy.

Counterpart of ``repro.sim.workloads`` (its model builders and the two
workload groups, layer for layer).  Two groups (§4.1): *heavy* multi-domain
(AlexNet, ResNet-50, GoogLeNet, SA_CNN, SA_LSTM, NCF, AlphaGoZero,
Transformer) and *light* RNN (Melody-LSTM, Google-Translate/GNMT, DeepVoice,
Handwriting-LSTM).  Layers use the standard published configuration of each
model at inference batch 1; LSTMs lower to one GEMM per layer with the four
gates fused and the time steps folded into the streamed dimension.
``chip_smoke.py`` takes its full-width GEMM rounds from these builders.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.dnng import DNNG, LayerShape, chain

# Conv(name, M, C, R, S, H, W, stride=1, pad=R // 2)
Conv = LayerShape.conv
FC = LayerShape.fc
LSTM = LayerShape.lstm_cell


# ---------------------------------------------------------------------------
# Heavy multi-domain workload
# ---------------------------------------------------------------------------


def alexnet() -> DNNG:
    return chain(
        "AlexNet",
        [
            Conv("conv1", 96, 3, 11, 11, 227, 227, stride=4, pad=0),
            Conv("conv2", 256, 96, 5, 5, 27, 27, pad=2),
            Conv("conv3", 384, 256, 3, 3, 13, 13),
            Conv("conv4", 384, 384, 3, 3, 13, 13),
            Conv("conv5", 256, 384, 3, 3, 13, 13),
            FC("fc6", 9216, 4096),
            FC("fc7", 4096, 4096),
            FC("fc8", 4096, 1000),
        ],
    )


def resnet50() -> DNNG:
    layers = [Conv("conv1", 64, 3, 7, 7, 224, 224, stride=2, pad=3)]
    spatial = 56
    in_ch = 64
    # (n_blocks, mid_channels, out_channels, first_stride)
    stage_cfg = [
        (3, 64, 256, 1),
        (4, 128, 512, 2),
        (6, 256, 1024, 2),
        (3, 512, 2048, 2),
    ]
    for s, (blocks, mid, out, stride0) in enumerate(stage_cfg):
        for b in range(blocks):
            stride = stride0 if b == 0 else 1
            h = spatial
            h2 = h // stride
            nm = f"s{s}b{b}"
            layers.append(Conv(f"{nm}_1x1a", mid, in_ch, 1, 1, h, h, stride, 0))
            layers.append(Conv(f"{nm}_3x3", mid, mid, 3, 3, h2, h2))
            layers.append(Conv(f"{nm}_1x1b", out, mid, 1, 1, h2, h2, pad=0))
            if b == 0:
                layers.append(Conv(f"{nm}_down", out, in_ch, 1, 1, h, h, stride, 0))
            in_ch = out
            spatial = h2
    layers.append(FC("fc", 2048, 1000))
    return chain("ResNet50", layers)


def googlenet() -> DNNG:
    """GoogLeNet (Inception v1) — the 9 inception modules, standard table."""
    layers = [
        Conv("conv1", 64, 3, 7, 7, 224, 224, stride=2, pad=3),
        Conv("conv2r", 64, 64, 1, 1, 56, 56, pad=0),
        Conv("conv2", 192, 64, 3, 3, 56, 56),
    ]
    # (name, H, C_in, #1x1, #3x3red, #3x3, #5x5red, #5x5, pool_proj)
    inception = [
        ("3a", 28, 192, 64, 96, 128, 16, 32, 32),
        ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
        ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
        ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
        ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
        ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
        ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
        ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
        ("5b", 7, 832, 384, 192, 384, 48, 128, 128),
    ]
    for nm, h, cin, c1, c3r, c3, c5r, c5, pp in inception:
        layers += [
            Conv(f"i{nm}_1x1", c1, cin, 1, 1, h, h, pad=0),
            Conv(f"i{nm}_3x3r", c3r, cin, 1, 1, h, h, pad=0),
            Conv(f"i{nm}_3x3", c3, c3r, 3, 3, h, h),
            Conv(f"i{nm}_5x5r", c5r, cin, 1, 1, h, h, pad=0),
            Conv(f"i{nm}_5x5", c5, c5r, 5, 5, h, h, pad=2),
            Conv(f"i{nm}_pool", pp, cin, 1, 1, h, h, pad=0),
        ]
    layers.append(FC("fc", 1024, 1000))
    return chain("GoogleNet", layers)


def _text_conv(name: str, M: int, C: int, R: int, seq: int) -> LayerShape:
    """A 1-D convolution of width R over a length-``seq`` sequence."""
    P = seq - R + 1
    return LayerShape(M=M, N=1, C=C, R=R, S=1, H=seq, W=1, P=P, Q=1, name=name)


def sa_cnn() -> DNNG:
    """Sentiment-analysis CNN [23]: conv windows over fastText embeddings."""
    seq, emb = 56, 300
    return chain(
        "SA_CNN",
        [
            _text_conv("conv3", 100, emb, 3, seq),
            _text_conv("conv4", 100, emb, 4, seq),
            _text_conv("conv5", 100, emb, 5, seq),
            FC("fc", 300, 2),
        ],
    )


def sa_lstm() -> DNNG:
    """Regional CNN-LSTM for dimensional sentiment [24]."""
    return chain(
        "SA_LSTM",
        [
            _text_conv("region_conv", 64, 300, 3, 56),
            LSTM("lstm1", input_size=64, hidden=512, steps=54),
            LSTM("lstm2", input_size=512, hidden=512, steps=54),
            FC("fc", 512, 2),
        ],
    )


def ncf() -> DNNG:
    """Neural collaborative filtering [25]: small MLP tower, batch folded."""
    batch = 256
    return chain(
        "NCF",
        [
            FC("mlp1", 256, 256, batch=batch),
            FC("mlp2", 256, 128, batch=batch),
            FC("mlp3", 128, 64, batch=batch),
            FC("mlp4", 64, 32, batch=batch),
            FC("predict", 32, 1, batch=batch),
        ],
    )


def alphagozero() -> DNNG:
    layers = [Conv("stem", 256, 17, 3, 3, 19, 19)]
    for i in range(19):
        layers.append(Conv(f"res{i}a", 256, 256, 3, 3, 19, 19))
        layers.append(Conv(f"res{i}b", 256, 256, 3, 3, 19, 19))
    layers += [
        Conv("policy_conv", 2, 256, 1, 1, 19, 19, pad=0),
        FC("policy_fc", 722, 362),
        Conv("value_conv", 1, 256, 1, 1, 19, 19, pad=0),
        FC("value_fc1", 361, 256),
        FC("value_fc2", 256, 1),
    ]
    return chain("AlphaGoZero", layers)


def transformer() -> DNNG:
    """Transformer-base [27]: 6 enc + 6 dec, d=512, d_ff=2048, seq 128.

    Block GEMMs only — the vocab projection is excluded, consistent with
    Scale-Sim topology files which model the recurrent/attention/FF GEMMs.
    """
    d, dff, seq = 512, 2048, 128
    layers = []
    for i in range(6):
        layers += [
            FC(f"enc{i}_qkv", d, 3 * d, batch=seq),
            FC(f"enc{i}_attn_out", d, d, batch=seq),
            FC(f"enc{i}_ff1", d, dff, batch=seq),
            FC(f"enc{i}_ff2", dff, d, batch=seq),
        ]
    for i in range(6):
        layers += [
            FC(f"dec{i}_qkv", d, 3 * d, batch=seq),
            FC(f"dec{i}_attn_out", d, d, batch=seq),
            FC(f"dec{i}_xqkv", d, 3 * d, batch=seq),
            FC(f"dec{i}_xattn_out", d, d, batch=seq),
            FC(f"dec{i}_ff1", d, dff, batch=seq),
            FC(f"dec{i}_ff2", dff, d, batch=seq),
        ]
    return chain("Transformer", layers)


# ---------------------------------------------------------------------------
# Light RNN workload
# ---------------------------------------------------------------------------


def melody_lstm() -> DNNG:
    """Melody extraction LSTM-RNN [28]: one 1 s chunk = 100 10-ms frames,
    512-unit 3-layer stack."""
    steps = 100
    return chain(
        "MelodyLSTM",
        [
            LSTM("lstm1", input_size=513, hidden=512, steps=steps),
            LSTM("lstm2", input_size=512, hidden=512, steps=steps),
            LSTM("lstm3", input_size=512, hidden=512, steps=steps),
            FC("out", 512, 722, batch=steps),
        ],
    )


def google_translate() -> DNNG:
    """GNMT [29]: 8 encoder + 8 decoder LSTM(1024) layers + attention, one
    20-token sentence; the vocab softmax projection is excluded."""
    steps = 20
    layers = [
        LSTM("enc_bi_fwd", input_size=1024, hidden=1024, steps=steps),
        LSTM("enc_bi_bwd", input_size=1024, hidden=1024, steps=steps),
    ]
    for i in range(6):
        layers.append(LSTM(f"enc{i + 2}", input_size=1024, hidden=1024, steps=steps))
    layers.append(FC("attention", 1024, 1024, batch=steps))
    for i in range(8):
        width = 1024 if i else 2048
        layers.append(LSTM(f"dec{i}", input_size=width, hidden=1024, steps=steps))
    return chain("GoogleTranslate", layers)


def deep_voice() -> DNNG:
    """Deep Voice [30]: segmentation/duration/f0 GRUs + vocoder stack (one
    0.1 s chunk at 16 kHz = 1600 vocoder steps, hidden 512)."""
    return chain(
        "DeepVoice",
        [
            LSTM("g2p_enc", input_size=256, hidden=256, steps=40),
            LSTM("g2p_dec", input_size=256, hidden=256, steps=40),
            LSTM("duration", input_size=256, hidden=256, steps=40),
            LSTM("f0_rnn", input_size=256, hidden=256, steps=80),
            LSTM("vocoder_rnn", input_size=512, hidden=512, steps=1600),
            FC("vocoder_proj", 512, 513, batch=1600),
        ],
    )


def handwriting_lstm() -> DNNG:
    """Fast multi-language online handwriting LSTM [31]: 3xLSTM over one
    200-point pen-stroke sequence."""
    steps = 200
    return chain(
        "HandwritingLSTM",
        [
            LSTM("lstm1", input_size=32, hidden=128, steps=steps),
            LSTM("lstm2", input_size=128, hidden=128, steps=steps),
            LSTM("lstm3", input_size=128, hidden=128, steps=steps),
            FC("ctc_out", 128, 100, batch=steps),
        ],
    )


# ---------------------------------------------------------------------------


def _stagger(dnngs: list[DNNG], step_s: float) -> list[DNNG]:
    """Arrival times per Fig. 4: A_t1..A_tn land inside L0 of DNNG_0."""
    return [
        dataclasses.replace(g, arrival_time=i * step_s) for i, g in enumerate(dnngs)
    ]


def heavy_workload(stagger_s: float = 2e-6) -> list[DNNG]:
    """Table 1, group 1 — multi-domain heavy load."""
    models = [alexnet, resnet50, googlenet, sa_cnn, sa_lstm, ncf, alphagozero]
    return _stagger([m() for m in models + [transformer]], stagger_s)


def light_workload(stagger_s: float = 2e-6) -> list[DNNG]:
    """Table 1, group 2 — RNN light load."""
    models = [melody_lstm, google_translate, deep_voice, handwriting_lstm]
    return _stagger([m() for m in models], stagger_s)
