"""Out-of-core OAVI on the port: chunked data sources, one-pass scaling, and
a streaming fit that rebuilds the evaluation matrix chunk by chunk and folds
it into Gram statistics on the device (counterpart of ``repro.streaming``).
``m`` is bounded by storage, or by nothing for generator-backed sources, not
by device memory, and the fit equals the in-memory fit bit for bit at
matched capacity."""

from .fit import (
    DEFAULT_CHUNK_ROWS,
    accumulate_source_range,
    fit,
    fit_classes,
    pearson_moments,
    prefetch_map,
    streaming_pearson_order,
)
from .scaler import StreamingMinMaxScaler
from .source import (
    ArraySource,
    DataSource,
    ScaledSource,
    ShardDirSource,
    SyntheticSource,
    as_source,
    is_source,
    iter_chunks,
)

__all__ = [
    "ArraySource",
    "DEFAULT_CHUNK_ROWS",
    "DataSource",
    "ScaledSource",
    "ShardDirSource",
    "StreamingMinMaxScaler",
    "SyntheticSource",
    "accumulate_source_range",
    "as_source",
    "fit",
    "fit_classes",
    "is_source",
    "iter_chunks",
    "pearson_moments",
    "prefetch_map",
    "streaming_pearson_order",
]
