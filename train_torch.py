#!/usr/bin/env python
"""`python train_torch.py <flags>`: train.py on the PyTorch port."""
from pix2pixhdaudiosr_torch.parallel import mesh
from pix2pixhdaudiosr_torch.train_loop import main
if __name__ == "__main__":
    main()
    mesh.shutdown()
