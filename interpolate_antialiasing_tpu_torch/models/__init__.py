from .aa_resize import AAResize
from .batch import ShapeBucketResizer, resize_mixed_batch
from .preprocess import (
    ImageNetEvalPipeline,
    ImageNetTrainPipeline,
    VideoDownscaler,
    imagenet_eval_preprocess,
)
from .pyramid import aa_pyramid
from .train import (
    ResizeConvNet,
    Trainer,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    params_from_jax,
)

__all__ = [
    "AAResize",
    "ImageNetEvalPipeline",
    "ImageNetTrainPipeline",
    "VideoDownscaler",
    "imagenet_eval_preprocess",
    "aa_pyramid",
    "resize_mixed_batch",
    "ShapeBucketResizer",
    "ResizeConvNet",
    "Trainer",
    "forward",
    "init_params",
    "loss_fn",
    "make_train_step",
    "params_from_jax",
]
