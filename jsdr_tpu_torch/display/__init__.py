"""Headless display reductions and renderers of the port: copies of
:mod:`jsdr_tpu.display.waterfall`, :mod:`jsdr_tpu.display.phase_scope`
and :mod:`jsdr_tpu.display.render` (numpy only)."""

from .phase_scope import phase_scope_data  # noqa: F401
from .render import (render_phase_png, render_psd_ascii,  # noqa: F401
                     render_spectrum_png, render_trace_ascii,
                     render_waterfall_png, write_png_rgb)
from .waterfall import Waterfall  # noqa: F401
