"""Population-genetics analyses on the port's substrate: ``grm``
(``grm.py``), ``ld-prune`` (``ld.py``) and ``assoc-scan`` (``assoc.py``)
over the shared plumbing of ``base.py``."""
