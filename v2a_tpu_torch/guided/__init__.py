"""Guided-diffusion CLI support: model/diffusion builders, image-folder
data, and the generic train loop behind `v2a_tpu_torch/scripts/guided/`
(counterpart of `v2a_tpu/guided/`, the reference's vendored
`guided_diffusion/{script_util,image_datasets,train_util}.py`)."""

from v2a_tpu_torch.guided.script_util import (  # noqa: F401
    NUM_CLASSES,
    classifier_and_diffusion_defaults,
    classifier_defaults,
    create_classifier_and_diffusion,
    create_gaussian_diffusion,
    create_model_and_diffusion,
    diffusion_defaults,
    model_and_diffusion_defaults,
    parser_from_defaults,
    sr_create_model_and_diffusion,
    sr_model_and_diffusion_defaults,
)
