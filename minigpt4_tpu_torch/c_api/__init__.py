"""The C ABI library of the port: ``libminigpt4_torch.so`` (the reference's
18 functions, ``minigpt4.h``) hosting this package in an embedded CPython
(``capi_host.py``), built with g++ by ``_build.py``."""
