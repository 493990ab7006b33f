"""Training loops and step factories (counterpart of ``repro/train``): the
LM stack's steps (``steps.py``), mini-batch GNN training
(``gnn_steps.py``) and its asynchronous batch pipeline (``pipeline.py``)."""
