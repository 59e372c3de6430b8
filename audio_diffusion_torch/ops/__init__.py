from . import attention, fused_groupnorm, griffin_lim, mel_filters, stft  # noqa: F401
