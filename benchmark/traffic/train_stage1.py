"""Stage-1 training: `FCNTrainer.train_epoch` over and over (config 14:
cosine loss on the 20-dim embeddings, Adam, channel dropout, the compact
uint8 feed through the port's `BatchLoader`, step logs read back once
every `log_flush_steps` steps). See `benchmark.training`."""

from benchmark.training import TrainDriver


class Driver(TrainDriver):
    stage = 1

    def make_trainer(self):
        from zeroshotsemanticsegmentation_tpu_torch.train import (
            FCNTrainer, make_fcn_optimizer)
        opt = make_fcn_optimizer(self.model, optim="adam",
                                 lr=float(self.mix["lr"]))
        return FCNTrainer(cfg=self.pcfg, model=self.model, optimizer=opt,
                          train_loader=self.loader, val_loader=self.loader,
                          logger=self.logger, embeddings=self.embed,
                          target_embeddings=self.embed,
                          upscore_trained=False)
