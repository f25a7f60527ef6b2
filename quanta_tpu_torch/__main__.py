from quanta_tpu_torch.cli import main

main()
