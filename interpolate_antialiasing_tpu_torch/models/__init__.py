from .preprocess import ImageNetEvalPipeline, imagenet_eval_preprocess

__all__ = ["ImageNetEvalPipeline", "imagenet_eval_preprocess"]
