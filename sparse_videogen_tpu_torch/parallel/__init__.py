"""Context (ring) parallelism over the token axis (counterpart of
sparse_videogen_tpu/parallel/): the communicator (comm.py), torchrun's
process group (mesh.py), the dense and SAP rings (ring.py, ring_sap.py) and
their runtimes (ring_runtime.py). Ulysses, USP and FSDP are not ported."""
