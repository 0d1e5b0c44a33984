"""The guided-diffusion CLIs: `python -m v2a_tpu_torch.scripts.guided.<name>`
for image_train, image_sample, image_nll, super_res_train,
super_res_sample, classifier_train and classifier_sample."""
