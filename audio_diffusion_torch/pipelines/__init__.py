from .pipeline import AudioDiffusionPipeline, PipelineOutput  # noqa: F401
