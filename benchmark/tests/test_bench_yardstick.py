"""The benchmark's frozen yardstick against the program's originals,
while both exist: ``kernel_cost`` and the peaks against chip_smoke's at
its shapes, ``device_busy_ms`` against the epoch benchmark's source."""

import inspect
import itertools

import pytest

import chip_smoke
from benchmark.yardstick import kernel_cost as frozen
from benchmark.yardstick import model_flops, trace

B, T, U = chip_smoke.B, chip_smoke.FRAMES // 4, chip_smoke.U_TRAIN - 1
ENC = dict(H=256, L=3, D2=2)
DEC = dict(H=512, L=3, E=128, A=512, V=chip_smoke.VOCAB)
SHAPES = [(B, T)] + [(b, t) for b, t in chip_smoke.TRAIN_PARTIAL]


@pytest.mark.parametrize("key,wbytes,shape", itertools.product(
    ("k1", "k1t", "k2", "k3", "k4", "k5", "k6"), (2, 4), SHAPES))
def test_kernel_cost_equals_chip_smoke(key, wbytes, shape):
    b, t = shape
    if key in ("k1", "k1t", "k2"):
        d = dict(ENC, B=b, T=t, wbytes=wbytes)
    else:
        d = dict(DEC, B=b, T=t, U=U, n_logits=12, n=chip_smoke.STOP,
                 stop=chip_smoke.STOP, N=chip_smoke.N_BEAM, wbytes=wbytes)
    assert frozen.kernel_cost(key, d) == chip_smoke.kernel_cost(key, d)
    for peak in (frozen.PEAK_F32_FLOPS, frozen.PEAK_BF16_FLOPS):
        assert (frozen.bound(*frozen.kernel_cost(key, d), peak=peak)
                == chip_smoke.bound(*chip_smoke.kernel_cost(key, d),
                                    peak=peak))


def test_peaks_equal_chip_smoke():
    assert (frozen.PEAK_F32_FLOPS, frozen.PEAK_BF16_FLOPS, frozen.PEAK_BYTES
            ) == (chip_smoke.PEAK_F32_FLOPS, chip_smoke.PEAK_BF16_FLOPS,
                  chip_smoke.PEAK_BYTES)


def test_device_busy_ms_is_the_epoch_benchmarks():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(chip_smoke.__file__), "scripts",
                        "torch_trainer_epoch_bench.py")
    spec = importlib.util.spec_from_file_location("epoch_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (inspect.getsource(trace.device_busy_ms)
            == inspect.getsource(mod.device_busy_ms))


def test_model_flops_uses_kernel_cost_terms():
    """The encoder's recurrence and a beam's decoder steps count what
    kernel_cost counts for K1 and K6 (the products the model needs)."""
    mcfg = {"rnn_config": {"hidden_units": 512, "embedding_units": 128,
                           "attn_units": 512, "enc_layers": 3,
                           "dec_layers": 3, "bi_rnn": True},
            "cnn_config": {"cnn_layers": []}}
    enc, tp = model_flops.encoder_flops(mcfg, B, T)
    k1 = frozen.kernel_cost("k1", dict(ENC, B=B, T=T))[0]
    assert tp == T and enc == k1 + 2 * T * 2 * B * 1 * 4 * 256
    steps = 37
    k6 = frozen.kernel_cost("k6", dict(DEC, B=B, T=T, n=steps, stop=175,
                                       N=5))[0]
    assert model_flops.beam_flops(mcfg, 1098, B, T, 5, steps) == enc + k6
