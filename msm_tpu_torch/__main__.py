"""``python -m msm_tpu_torch``: the command line (``msm_tpu_torch.cli``)."""

from msm_tpu_torch.cli import main

if __name__ == "__main__":
    main()
