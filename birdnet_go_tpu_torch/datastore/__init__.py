"""Persistence layer: the SQLite datastore (a copy of
``birdnet_go_tpu/datastore/sqlite.py``, same schema, SQL and migrations)
and the MySQL one over a wire-level client (``mysql.py``,
``mysql_wire.py``)."""

from birdnet_go_tpu_torch.datastore.sqlite import Datastore

__all__ = ["Datastore"]
