"""Population-genetics analyses on the port's substrate: ``grm``
(``grm.py``), ``ld-prune`` (``ld.py``) and ``assoc-scan`` (``assoc.py``)
over the shared plumbing of ``base.py``; and the reference's examples:
``search-variants-klotho``/``-brca1`` (``variants_examples.py``) and
``search-reads-example-1`` … ``-4`` (``reads_examples.py``, on the kernels
of ``ops/depth.py``)."""
