"""Parallel training strategies of the port: the DownPour parameter server
(``async_ps``, ``sharded_ps``, ``optplane``) and, over the device mesh of
``runtime/mesh.py``, sync data parallelism (``sync``), local SGD
(``local_sgd``), p2p (``p2p``), FSDP (``fsdp``), tensor parallelism
(``tensor_parallel``), ring attention (``ring``) and the sequence-parallel
steps over it (``seq_parallel``), Ulysses sequence parallelism
(``ulysses``), the GPipe/1F1B/interleaved pipeline with dp and tp
(``pipeline``), dp × ep MoE (``expert_parallel``) and the composite
dp × fsdp × tp step (``composite``)."""
