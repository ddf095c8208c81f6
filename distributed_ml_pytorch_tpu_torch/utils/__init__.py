"""Host-side utilities of the port: the flat wire layout (``serialization``),
weights from the JAX package (``interop``), the tagged-tensor transports
(``messaging``), liveness (``failure``) and the training CSV (``metrics``)."""
