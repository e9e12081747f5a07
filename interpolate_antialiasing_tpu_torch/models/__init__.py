from .aa_resize import AAResize
from .preprocess import (
    ImageNetEvalPipeline,
    ImageNetTrainPipeline,
    VideoDownscaler,
    imagenet_eval_preprocess,
)
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
    "ResizeConvNet",
    "Trainer",
    "forward",
    "init_params",
    "loss_fn",
    "make_train_step",
    "params_from_jax",
]
