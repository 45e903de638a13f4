"""A frozen copy of the ORB extraction that the configurations state
(pyramid, FAST, cell selection, orientation, BRIEF), in plain torch.  It
imports nothing of the program; `common.STORAGE` set to a lower precision
makes the control."""
