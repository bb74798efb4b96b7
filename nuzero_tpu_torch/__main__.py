from nuzero_tpu_torch.run import main

if __name__ == "__main__":
    main()
