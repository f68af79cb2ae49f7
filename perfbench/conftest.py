def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips at run time where torch sees none"
    )
