"""ScanNet tooling of the port (google_nerf_tpu/scannet_tools/):

  native       zlib decompression of .sens depth frames, one buffer or a
               batch on a thread pool (csrc/sens_decode.cpp, built at
               first use; a failed build raises)
  sensor_data  the .sens v4 reader (memory-mapped header, lazy frame
               index), its exporters and write_sens
  process      process_scene, split_train_test, prepare_batch and the
               `python -m google_nerf_tpu_torch.scannet_tools.process`
               CLI (scene / batch / split); the NYU40 label helpers
"""
