"""The harness's own CPU tests (the card's runs are the benchmark's)."""
