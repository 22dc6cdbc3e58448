from .entropy_models import (
    CdfTables,
    EntropyBottleneck,
    EntropyBottleneckCoder,
    GaussianConditionalCoder,
    build_eb_tables,
    build_gc_tables,
    gaussian_build_indexes,
    gaussian_forward,
    gaussian_likelihood,
    get_scale_table,
)

__all__ = [
    "CdfTables",
    "EntropyBottleneck",
    "EntropyBottleneckCoder",
    "GaussianConditionalCoder",
    "build_eb_tables",
    "build_gc_tables",
    "gaussian_build_indexes",
    "gaussian_forward",
    "gaussian_likelihood",
    "get_scale_table",
]
