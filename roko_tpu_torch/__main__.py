from roko_tpu_torch.cli import main

if __name__ == "__main__":
    import sys

    from roko_tpu_torch.parallel import distributed

    try:
        rc = main()
    finally:
        distributed.shutdown()
    sys.exit(rc)
