"""Data and tensor parallelism over ``torch.distributed`` (port of
``myrtlespeech_tpu/parallel/``): the ``(data, model)`` mesh of ranks
(``mesh.py``), the parameters' shard rule (``sharding.py``) and the
collectives of tensor parallelism (``tensor.py``)."""
