"""Tools of the port (`python -m singa_tpu_torch.tools.<name>`): `viz`
(net JSON to Graphviz dot, training-log curves), `export_examples`
(the example configs from the model zoo), `convergence_run` (LeNet to
99% on the card, the time-to-99) and `loader` (the reference's data
loader: shards from MNIST, CIFAR-10 or an image folder, split,
partition, mean, LMDB conversion)."""
