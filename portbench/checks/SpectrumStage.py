"""Check of ``SpectrumStage`` with a waterfall width: every checked
block's 'fft-psd' (the dB PSD of each 0.1 s sub-block) and
'waterfall-line' (its 8-bit lines) against the plain reference.

- ``psd_gap_db``: the widest dB gap on bins at or above each row's
  median (``reference.spectrum.db_gap``);
- ``line_gap``: how far the reference's intensity lies outside the 8-bit
  value the program stored (``reference.spectrum.u8_gap``);
- ``outputs_missing``: checked blocks with no PSD or no line.
"""

import torch

from portbench.checklib import cast_u8, group_block
from portbench.reference import spectrum as SP


def numbers(params, start, sampled, dev, control):
    if not params.get("waterfall_width"):
        raise ValueError("the SpectrumStage check covers the waterfall form "
                         "(waterfall_width set)")
    n, width = params["fft_n"], params["waterfall_width"]
    out = dict(psd_gap_db=0.0, line_gap=0.0, outputs_missing=0)
    for g in start + sampled:
        for off, raw in enumerate(g.raw):
            psd = group_block(g, "fft-psd", off)
            line = group_block(g, "waterfall-line", off)
            ref = SP.psd_db(raw, n, dev, window=params["window"])
            if control:
                psd = SP.psd_db(raw, n, dev, torch.bfloat16,
                                window=params["window"])
                line = cast_u8(SP.line_intensity(psd, width))
            elif psd is None or line is None:
                out["outputs_missing"] += 1
                continue
            psd = torch.as_tensor(psd, device=dev)
            line = torch.as_tensor(line, device=dev)
            out["psd_gap_db"] = max(out["psd_gap_db"], SP.db_gap(psd, ref))
            out["line_gap"] = max(out["line_gap"], SP.u8_gap(
                line, SP.line_intensity(ref, width)))
    return out
