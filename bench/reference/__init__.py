"""The plain reference that decides ``correct``: OAVI (Algorithm 1 with the
closed-form least-squares decisions), the generator transform and the l1
squared-hinge linear SVM, in plain PyTorch at float64.

It imports nothing of the program and nothing of the JAX package, and takes
nothing the program has made: it receives the cell's raw inputs and works
out the scaling, the feature order, the borders, every least-squares
solution, the features and the SVM itself.  The program's outputs are read
only to be judged.  The same code at ``prec="tf32"`` (float32 with every
matrix product's operands rounded to TF32) is the control that must come
out as not correct.
"""
