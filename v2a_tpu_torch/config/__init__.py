from v2a_tpu_torch.config.experiment import (  # noqa: F401
    ExperimentConfig,
    apply_overrides,
    generate_exp_name,
    load_config_module,
    load_snapshot,
    parse_cli,
    save_snapshot,
)
