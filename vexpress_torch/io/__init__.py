from .loaders import (
    apply_model_overrides,
    default_pipeline_models,
    init_pipeline_random_,
    init_random_,
    load_jax_params,
    load_pipeline,
    load_pipeline_jax_params,
)

__all__ = [
    "apply_model_overrides",
    "default_pipeline_models",
    "init_pipeline_random_",
    "init_random_",
    "load_jax_params",
    "load_pipeline",
    "load_pipeline_jax_params",
]
