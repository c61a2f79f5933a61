"""Command-line entry points:
`python -m zeroshotsemanticsegmentation_tpu_torch.cli.train`."""
