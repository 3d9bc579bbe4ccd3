"""Host-side C++ of the data plane and the tracer (port of ``native/``):
``graphpack`` (shard files), ``diststore.cpp`` (bound by
``data/distdataset.py``) and ``regiontimer``, built by ``build.py``."""
