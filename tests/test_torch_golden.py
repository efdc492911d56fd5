"""Golden parity through the port on the CPU: the committed IQ captures
(tests/golden, see make_golden.py) decode through ``jsdr_tpu_torch`` in
1 s blocks to the exact committed payloads, rc and hit_corr — the same
contract tests/test_golden.py holds the JAX package to."""

from pathlib import Path

import numpy as np
import pytest

from jsdr_tpu.io.convert import s16le_to_complex
from jsdr_tpu_torch.demod.bpsk import BpskConfig, bpsk_block, bpsk_init
from jsdr_tpu_torch.fec.decoder import fec_decode
from jsdr_tpu_torch.ops.cplx import from_complex, to_complex

GOLDEN = Path(__file__).parent / "golden"


@pytest.mark.parametrize("name", ["golden_96k.npz", "golden_192k.npz"])
def test_golden_capture_decodes_bit_exact_through_port(name):
    g = np.load(GOLDEN / name)
    rate = int(g["rate"])
    sig = s16le_to_complex(np.asarray(g["raw_s16le"]))
    sig = np.concatenate([sig, np.zeros((-len(sig)) % rate, np.complex64)])
    np.testing.assert_array_equal(to_complex(from_complex(sig, "cpu")), sig)
    cfg = BpskConfig(rate=rate, tuning=float(g["tuning"]))
    st = bpsk_init(cfg, "cpu")
    payloads, rcs, corrs = [], [], []
    for b in range(len(sig) // rate):
        out, st = bpsk_block(from_complex(sig[b * rate:(b + 1) * rate], "cpu"),
                             cfg, st)
        nh = int(out.n_hits)
        if nh:
            res = fec_decode(out.windows[:nh])
            assert bool(res.ok.all())
            payloads += list(res.payload.numpy())
            rcs += res.rc.tolist()
            corrs += out.hit_corr[:nh].tolist()
    np.testing.assert_array_equal(np.stack(payloads), g["payloads"])
    assert rcs == list(g["rc"])
    assert corrs == list(g["hit_corr"])
