from .refprior import RefPriorConfig, MODEL_FAMILIES  # noqa: F401
