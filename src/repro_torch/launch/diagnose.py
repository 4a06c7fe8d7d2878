"""Deprecated shim — moved to :mod:`repro_torch.obs.diagnose`."""

from repro_torch.obs.diagnose import lower_and_text, main  # noqa: F401

if __name__ == "__main__":
    main()
