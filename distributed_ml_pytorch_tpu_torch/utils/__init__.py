"""Host-side utilities of the port: the flat wire layout (``serialization``),
weights from the JAX package (``interop``), the tagged-tensor transports
(``messaging``), liveness (``failure``), the training CSV and the serving
SLO percentiles (``metrics``), step timing (``tracing``), correlation ids
(``obs``), and the parameter server's durable writes (``durability``),
write-ahead log (``wal``) and admission gate (``health``)."""
