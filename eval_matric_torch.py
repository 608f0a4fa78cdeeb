#!/usr/bin/env python
"""`python eval_matric_torch.py <flags>`: eval_matric.py on the PyTorch port
(the reference's spelling kept)."""
from pix2pixhdaudiosr_torch.evaluate import main

if __name__ == "__main__":
    main()
