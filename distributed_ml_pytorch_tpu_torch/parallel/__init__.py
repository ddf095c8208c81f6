"""Parallel training strategies of the port: the DownPour parameter server
(``async_ps``, ``sharded_ps``, ``optplane``) and, over the device mesh of
``runtime/mesh.py``, sync data parallelism (``sync``), local SGD
(``local_sgd``), p2p (``p2p``), FSDP (``fsdp``) and tensor parallelism
(``tensor_parallel``)."""
