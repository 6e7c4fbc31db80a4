from spark_examples_tpu_torch.cli import main

raise SystemExit(main())
