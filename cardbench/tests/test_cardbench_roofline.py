"""The bound and mfu of one heavy wave, against numbers worked by hand."""

import pytest

from cardbench import harness, roofline

# wave 0 of table1-heavy at batch 128, (T, K, N): AlexNet conv1 (55 x 55
# pixels, 3 x 11 x 11, 96), ResNet-50 and GoogLeNet conv1 (112 x 112, 3 x 7 x
# 7, 64), SA_CNN conv3 (54 positions, 300 x 3, 100), SA_LSTM region conv (54,
# 300 x 3, 64), NCF mlp1 (256 rows, 256, 256), AlphaGoZero stem (19 x 19, 17
# x 3 x 3, 256), Transformer enc0 qkv (128 tokens, 512, 1536)
WAVE0 = [
    (3025 * 128, 363, 96),
    (12544 * 128, 147, 64),
    (12544 * 128, 147, 64),
    (54 * 128, 900, 100),
    (54 * 128, 900, 64),
    (256 * 128, 256, 256),
    (361 * 128, 153, 256),
    (128 * 128, 512, 1536),
]
# 2 T K N each, summed
FLOPS = 2 * (
    387200 * 363 * 96
    + 2 * 1605632 * 147 * 64
    + 6912 * 900 * 100
    + 6912 * 900 * 64
    + 32768 * 256 * 256
    + 46208 * 153 * 256
    + 16384 * 512 * 1536
)
# bf16 operands read once, f32 outputs written once
BYTES = (
    (387200 * 363 + 363 * 96) * 2 + 387200 * 96 * 4
    + 2 * ((1605632 * 147 + 147 * 64) * 2 + 1605632 * 64 * 4)
    + (6912 * 900 + 900 * 100) * 2 + 6912 * 100 * 4
    + (6912 * 900 + 900 * 64) * 2 + 6912 * 64 * 4
    + (32768 * 256 + 256 * 256) * 2 + 32768 * 256 * 4
    + (46208 * 153 + 153 * 256) * 2 + 46208 * 256 * 4
    + (16384 * 512 + 512 * 1536) * 2 + 16384 * 1536 * 4
)


def test_wave0_is_the_config_s_first_wave():
    drv = harness.module("drivers", "gemm_rounds")
    plan = drv.waves(harness.config("table1-heavy"), 128)
    assert [s for _, s in plan[0]] == WAVE0


def test_bound_of_heavy_wave0_by_hand():
    assert roofline.call_flops(WAVE0) == FLOPS == 123_134_377_984
    assert roofline.call_bytes(WAVE0, "bfloat16") == BYTES == 2_456_818_272
    # bytes-bound: 2.4568 GB / 3.35 TB/s = 0.73338 ms
    #            > 123.1 GFLOP / 989 TFLOP/s = 0.1245 ms
    assert BYTES / roofline.PEAK_BYTES_PER_S > FLOPS / roofline.PEAK_FLOPS["bfloat16"]
    bound = roofline.call_bound_s(WAVE0, "bfloat16")
    assert bound == pytest.approx(7.3337859e-4, rel=1e-7)


def test_mfu_and_roofline_readers_by_hand():
    # that wave five times in a 14 ms traced window, its kernels 12 ms, the
    # device busy 12.6 ms
    record = {
        "peak_flops": 989e12,
        "trace": {
            "flops": 5 * FLOPS,
            "bound_s": 5 * 7.3337859e-4,
            "kernel_s": 12e-3,
            "busy_s": 12.6e-3,
            "window_s": 14e-3,
        },
    }
    # 615.67 GFLOP over 14 ms x 989 TFLOP/s
    mfu = harness.module("metrics", "mfu").read(record)
    assert mfu == pytest.approx(100 * 615_671_889_920 / (14e-3 * 989e12))
    assert mfu == pytest.approx(4.44657, abs=1e-5)
    # 3.6669 ms of bound over 12 ms of kernels
    roof = harness.module("metrics", "kernel_roofline").read(record)
    assert roof == pytest.approx(30.5574, abs=1e-4)
    assert harness.module("metrics", "device_idle").read(record) == pytest.approx(10.0)


@pytest.mark.parametrize(
    "name", ["kernel_roofline", "device_idle", "mfu", "enqueue_us"]
)
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = {"peak_flops": 989e12, "trace": None, "calls": 0, "enqueue_s": 0.0}
    assert harness.module("metrics", name).read(empty) is None
    trace = {"flops": 1, "bound_s": 1, "kernel_s": None, "busy_s": 0.0, "window_s": 1}
    no_device = {**empty, "trace": trace}
    assert harness.module("metrics", name).read(no_device) is None
