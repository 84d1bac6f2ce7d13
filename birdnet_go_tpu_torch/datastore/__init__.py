"""Persistence layer: the SQLite datastore (a copy of
``birdnet_go_tpu/datastore/sqlite.py``, same schema, SQL and migrations)."""

from birdnet_go_tpu_torch.datastore.sqlite import Datastore

__all__ = ["Datastore"]
