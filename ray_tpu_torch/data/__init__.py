"""ray_tpu_torch.data: distributed datasets (the port of ray_tpu.data).

Public surface mirrors the reference's ray.data creation APIs:
range / from_items / from_numpy / read_parquet / read_csv / read_json.
Batches reach the card through Dataset/DataIterator.iter_torch_batches.
Importing this package loads no torch; only the feed to a device does.
"""

from ray_tpu_torch.data import aggregate
from ray_tpu_torch.data.aggregate import Count, Max, Mean, Min, Std, Sum
from ray_tpu_torch.data.datasource import (
    Datasink,
    Datasource,
    FileBasedDatasink,
    FileBasedDatasource,
    ReadTask,
)
from ray_tpu_torch.data.executor import ActorPoolStrategy
from ray_tpu_torch.data.feed import FeedStats
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.dataset import (
    Dataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range_dataset as range,  # noqa: A001 — mirrors ray.data.range
    read_bigquery,
    read_binary_files,
    read_images,
    read_mongo,
    read_numpy,
    read_csv,
    read_datasource,
    read_json,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)

__all__ = [
    "ActorPoolStrategy",
    "DataIterator",
    "Datasink",
    "Datasource",
    "Dataset",
    "FeedStats",
    "FileBasedDatasink",
    "FileBasedDatasource",
    "ReadTask",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_binary_files",
    "read_images",
    "read_numpy",
    "read_datasource",
    "read_parquet",
    "read_text",
    "read_csv",
    "read_json",
    "aggregate",
    "Count",
    "Sum",
    "Min",
    "Max",
    "Mean",
    "Std",
]
