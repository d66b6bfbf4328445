from metta_tpu_torch.cogames.main import main

if __name__ == "__main__":
    raise SystemExit(main())
