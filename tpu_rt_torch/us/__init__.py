"""Ultrasound post-processing: DAS beamforming, envelopes, B-mode, the
end-to-end ``us_render``, and ultraspy-compatible facades (build_probe /
GridScan / DelayAndSum).  Counterpart of ``tpu_rt/us``."""

from tpu_rt_torch.us.api import DelayAndSum, GridScan, Probe, build_probe  # noqa: F401
from tpu_rt_torch.us.beamform import (  # noqa: F401
    apply_pulse,
    bmode_pipeline,
    das_adjoint,
    das_beamform,
    das_beamform_matmul,
    grid_scan,
    hilbert_envelope,
    log_compress,
    pulse_kernel,
)
from tpu_rt_torch.us.pipeline import us_render, us_render_fast, us_render_jit  # noqa: F401
