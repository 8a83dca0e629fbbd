"""Training of the port: AdamW, the bigram data pipeline, the train step
and ``.npz`` checkpoints, each the reference's ``training/`` module in
PyTorch."""
