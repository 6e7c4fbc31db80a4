"""Population-genetics analyses on the port's substrate: ``grm``
(``grm.py``) over the shared plumbing of ``base.py``."""
