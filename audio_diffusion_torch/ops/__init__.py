from . import attention, fused_groupnorm, griffin_lim, mel_filters, stage_mark, stft  # noqa: F401
