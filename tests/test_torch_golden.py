"""The frozen golden corpus (tests/golden/golden.npz, recipe
tests/make_golden.py) through aukit_tpu_torch's whole-file decoders and
loaders on the CPU (twins of tests/test_golden.py): integer samples bit-equal
to the committed vectors, and each loader's float samples equal to the JAX
package's normalisation of them. The DFPWM byte-level and kernel golden twins
live in tests/test_torch_dfpwm.py."""

import os

import numpy as np
import pytest

import aukit_tpu_torch as tk
from aukit_tpu.ops import pcmcode as jpcm
from aukit_tpu_torch.codecs.adpcm import decode_ima_adpcm, decode_msadpcm
from aukit_tpu_torch.codecs.g711 import decode_g711
from aukit_tpu_torch.codecs.qoa import decode_qoa

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden.npz")

pytestmark = pytest.mark.skipif(not os.path.exists(GOLDEN), reason="corpus not generated")


@pytest.fixture(scope="module")
def corpus():
    return np.load(GOLDEN)


def test_dfpwm_golden_through_the_loader(corpus):
    a = tk.dfpwm(corpus["dfpwm_in"].tobytes(), 1, 48000, device="cpu")
    np.testing.assert_array_equal(a.numpy()[0],
                                  jpcm.normalize_pcm(corpus["dfpwm_out"], 8, "signed"))


def test_g711_golden(corpus):
    raw = corpus["g711_in"].tobytes()
    for ulaw, key in ((True, "g711_ulaw_out"), (False, "g711_alaw_out")):
        want = corpus[key].astype(np.float32)
        np.testing.assert_array_equal(decode_g711(raw, ulaw, 1)[0], want)
        np.testing.assert_array_equal(tk.g711(raw, ulaw, device="cpu").numpy()[0], want)


def test_ima_golden(corpus):
    raw = corpus["ima_in"].tobytes()
    out = decode_ima_adpcm(raw, 1, True, True, predictor=[123], step_index=[17], device="cpu")
    np.testing.assert_array_equal(out[0], corpus["ima_out"])
    a = tk.adpcm(raw, 1, 48000, True, True, [123], [17], device="cpu")
    np.testing.assert_array_equal(a.numpy(), jpcm.normalize_pcm(out, 16, "signed"))


def test_ms_golden(corpus):
    raw = corpus["ms_in"].tobytes()
    out = decode_msadpcm(raw, 256, 2, device="cpu")
    np.testing.assert_array_equal(out, corpus["ms_out"])
    a = tk.msadpcm(raw, 256, 2, device="cpu")
    np.testing.assert_array_equal(a.numpy(), jpcm.normalize_pcm(corpus["ms_out"], 16, "signed"))


def test_qoa_golden(corpus):
    out, _, _ = decode_qoa(corpus["qoa_in"].tobytes(), device="cpu")
    np.testing.assert_array_equal(out, corpus["qoa_out"])
    a = tk.qoa(corpus["qoa_in"].tobytes(), device="cpu")
    np.testing.assert_array_equal(a.numpy(), jpcm.normalize_pcm(corpus["qoa_out"], 16, "signed"))
