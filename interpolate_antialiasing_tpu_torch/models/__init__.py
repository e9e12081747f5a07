from .preprocess import ImageNetEvalPipeline, VideoDownscaler, imagenet_eval_preprocess

__all__ = ["ImageNetEvalPipeline", "VideoDownscaler", "imagenet_eval_preprocess"]
