"""Examples on the port, the counterparts of ``examples/*.py``: each keeps
its original's name and output, and runs as a module::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_with_tuning
    PYTHONPATH=src python -m repro_torch.examples.train_lm
    PYTHONPATH=src python -m repro_torch.examples.transfer_tuning_demo

The ones that run a model run it on the card unless given ``--device cpu``.
The tuning examples are analytical: their seconds are the cost model's
(model seconds, printed as such), and the search seconds virtual.
"""
