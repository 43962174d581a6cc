"""Tensor ops and the hand-written Hopper kernels (port of
``onset_fingerprinting_tpu.ops``; the kernels' wrappers build their CUDA
libraries at first launch, see ``_cuda.py``, so importing this package
builds nothing)."""

from onset_fingerprinting_torch.ops.envelope import (
    ar_envelope,
    ar_envelope_block,
    minmax_envelope,
    MinMaxState,
)
from onset_fingerprinting_torch.ops.filters import (
    IIRState,
    butterworth,
    iir_apply,
    median_filter_1d,
    sliding_max,
    sliding_mean,
)
from onset_fingerprinting_torch.ops.xcorr import (
    StreamingCC,
    batch_full_correlate,
    cross_correlation_lag,
    cross_correlation_lag_jax,
    find_lag,
    find_lag_multi,
    full_correlate,
    streaming_cc_init,
    streaming_cc_update,
)
from onset_fingerprinting_torch.ops.stft import (
    a_weighting,
    cspec_to_mfcc,
    mel_filterbank,
    onset_stft,
    power_to_db,
    spectral_flux,
    stft,
    window_contribution_weights,
)
