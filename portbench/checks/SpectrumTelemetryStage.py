"""Check of ``SpectrumTelemetryStage``: the telemetry numbers of
``checklib.telemetry_numbers``, and the display spectrum it publishes at
each drain for the drain's last block (tab 0's stream, which every tab
shares) against the plain reference:

- ``wf_gap_db``: the widest dB gap of the 'waterfall-line' pixels (the
  maximum over runs of q consecutive bins, natural order) on pixels at or
  above each line's median;
- ``peak_gap_db``: of 'fft-peak' (the last sub-block's peak), the larger
  of the gap between its dB and the reference's peak dB and how far the
  reference's bin at its frequency lies below the reference's peak;
- ``outputs_missing``: checked drains with no line or no peak.
"""

import torch

from portbench.checklib import group_block, telemetry_numbers
from portbench.reference import spectrum as SP


def numbers(params, start, sampled, dev, control):
    out = telemetry_numbers(params, start, sampled, dev, control)
    rate = params["rate"]
    n = rate // 10
    out.update(wf_gap_db=0.0, peak_gap_db=0.0, outputs_missing=0)
    for g in start + sampled:
        raw = g.raw[-1]
        line = group_block(g, "waterfall-line", g.size - 1)
        peak = group_block(g, "fft-peak", g.size - 1)
        ref = SP.psd_db(raw, n, dev, window=params["window"])
        if control:
            got = SP.psd_db(raw, n, dev, torch.bfloat16,
                            window=params["window"])
            width = line.shape[-1] if line is not None else n // 10
            line = SP.group_max(got, width)
            k = int(torch.argmax(got[-1]))
            peak = ((k if k < n // 2 else k - n) * rate // n,
                    float(got[-1, k]))
        elif line is None or peak is None:
            out["outputs_missing"] += 1
            continue
        line = torch.as_tensor(line, device=dev)
        out["wf_gap_db"] = max(out["wf_gap_db"], SP.db_gap(
            line, SP.group_max(ref, line.shape[-1])))
        top = float(ref[-1].max())
        k = round(peak[0] * n / rate) % n
        out["peak_gap_db"] = max(out["peak_gap_db"], abs(peak[1] - top),
                                 top - float(ref[-1, k]))
    return out
