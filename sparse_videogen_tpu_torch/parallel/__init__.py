"""Parallelism (counterpart of sparse_videogen_tpu/parallel/): the
communicator (comm.py), torchrun's dp x rp x sp rank grid (mesh.py), the
dense and SAP rings (ring.py, ring_sap.py), their runtimes
(ring_runtime.py), Ulysses head sharding (ulysses.py) and FSDP weight
sharding (sharding.py). pipelines/runtime.make_runtime picks the runtime
of a rank group."""
